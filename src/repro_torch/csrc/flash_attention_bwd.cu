// GQA flash attention, backward: dQ, dK and dV of the forward in
// flash_attention.cu (causal or not, with an optional sliding window).
//
// Replaces no TPU kernel: the JAX package trains by XLA autodiff of its
// jnp attention and never differentiates its Pallas kernel
// (src/repro/kernels/flash_attention/kernel.py has no backward). The port's
// training forward runs the hand kernel, whose output has no autograd
// history, so its gradient is this hand kernel too (ops.py's
// autograd.Function). For query head h of batch b over key head
// h * KV / H, with s = q k^T * sm_scale masked as the forward masks it,
//   P = softmax(s) = exp(s - lse),  Delta = rowsum(dO o O)
//   dP = dO V^T,  dS = P o (dP - Delta)
//   dQ = sm_scale dS K,  dK = sm_scale dS^T Q,  dV = P^T dO
// summed over the H / KV query heads of a key head for dK and dV.
//
// Layout: q, o, dO (B, H, S, D) and k, v (B, KV, S, D) are strided views
// (unit-stride last dim), as the forward takes them; dQ is written in the
// model's (B, S, H, D) layout and dK, dV in (B, S, KV, D), contiguous, in
// the inputs' dtype. Float32 or bf16 in, float32 arithmetic throughout.
//
// Bound on the H100 at qwen2-1.5b's training shape (B, S, H, KV, D) =
// (4, 512, 12, 2, 128), bf16, causal: it must read q, k, v, O, dO and
// write dQ, dK, dV once, 2 * (4 B H S D + 4 B KV S D) = 29.4 MB, 8.76 us
// at 3.35 TB/s, and needs the five products of the causal half,
// 10 * B * H * D * S (S + 1) / 2 = 8.07 GFLOP, 8.16 us on the bf16
// tensor cores: bytes bound it, by a little. This first kernel runs its
// products as scalar float32 FMAs (67 TFLOP/s at most, 120 us for those
// operations), so it is expected far from that bound (PERF.md).
//
// Design (simple and correct first; wgmma and TMA are later work):
//  - Three launches, deterministic, no atomics. (1) A block per (query
//    tile of 64 rows, head, batch): Delta from O and dO, then over the
//    key tiles the row's logsumexp (online max and sum, as the forward),
//    then over the key tiles again P, dP, dS and dQ += dS K; it writes dQ
//    and each row's lse and Delta (float32 scratch, (B, H, S)). (2) A
//    block per (key tile of 64 rows, query head, batch) walks the query
//    tiles that see its keys and accumulates that head's share of dK and
//    dV in registers, written to float32 scratch (B, S, H, D); a block
//    per KV head instead would leave most SMs idle (64 blocks at qwen2's
//    training shape). (3) dK and dV sum the H / KV shares of each key
//    head in head order, in the inputs' dtype.
//  - Scalar float32 FMAs from shared memory, as the forward's float32
//    kernel: 256 threads (16 x 16); in a 64 x 64 score tile thread (ty,
//    tx) owns rows ty + 16 i and columns tx + 16 j, in a 64 x D
//    accumulator rows ty + 16 i and columns tx + 16 c. Rows padded by 4
//    floats (float4 reads). Key tiles wholly in a query tile's future or
//    wholly out of its window are skipped, in both launches.
//  - Shared memory at D = 128: 151,808 bytes for (1), 168,960 for (2);
//    one block an SM. Scratch: 2 B H S (lse, Delta) + 2 B S H D floats.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kB = 64;          // query rows and key rows a tile
constexpr int kThreads = 256;   // 16 x 16

// element strides over (batch, head, position) of q, k, v, o, dO
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Layout {
  static constexpr int kDP = D + 4;   // padded row stride of a 64 x D tile
  static constexpr int kPS = kB + 1;  // row stride of a 64 x 64 tile
  static constexpr int kTile = kB * kDP;
  static constexpr int kP = kB * kPS;
  static constexpr size_t kBytesDq = sizeof(float) * (4 * kTile + kP);
  static constexpr size_t kBytesDkv =
      sizeof(float) * (4 * kTile + 2 * kP + 2 * kB);
};

// rows r0 .. r0 + 63 of a (S, D) matrix with row stride `rs`, times
// `scale`, into a padded float tile; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int r0, int s,
                                          float scale) {
  constexpr int kDP = Layout<D>::kDP;
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * kDP + c] =
        (r0 + r < s) ? ld(src + (long long)(r0 + r) * rs + c) * scale : 0.0f;
  }
}

// out[i][j] = a[ty + 16 i] . b[tx + 16 j] over D, both padded tiles
template <int D>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int ty, int tx, float (&out)[4][4]) {
  constexpr int kDP = Layout<D>::kDP;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&a[(ty + 16 * i) * kDP + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * kDP + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = out[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        out[i][j] = x;
      }
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int s,
                                        int causal, int window) {
  return qpos < s && kpos < s && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// the key tiles a query tile [q0, q0 + 63] sees: [*first, *last)
__device__ __forceinline__ void key_tiles(int q0, int s, int causal,
                                          int window, int* first,
                                          int* last) {
  const int nt = (s + kB - 1) / kB;
  *last = causal ? min(nt, (q0 + kB - 1) / kB + 1) : nt;
  *first = window > 0 ? max(0, (q0 - window + 1) / kB) : 0;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ o,
                           const T* __restrict__ g, T* __restrict__ dq,
                           float* __restrict__ lse_out,
                           float* __restrict__ delta_out, Strides st, int h,
                           int kv, int s, int causal, int window,
                           float sm_scale) {
  using L = Layout<D>;
  constexpr int kDP = L::kDP;
  constexpr int kPS = L::kPS;
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // q * sm_scale
  float* sg = sq + L::kTile;                    // dO
  float* sk = sg + L::kTile;
  float* sv = sk + L::kTile;
  float* sp = sv + L::kTile;                    // dS

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kB;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (h / kv);
  const T* qb = q + bb * st.q[0] + hh * st.q[1];
  const T* kb = k + bb * st.k[0] + kvh * st.k[1];
  const T* vb = v + bb * st.v[0] + kvh * st.v[1];
  const T* ob = o + bb * st.o[0] + hh * st.o[1];
  const T* gb = g + bb * st.g[0] + hh * st.g[1];

  load_tile<T, D>(sq, qb, st.q[2], q0, s, sm_scale);
  load_tile<T, D>(sg, gb, st.g[2], q0, s, 1.0f);
  __syncthreads();

  // Delta = rowsum(dO o O); a row's 16 owners are one half-warp
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float acc = 0.0f;
    if (q0 + r < s)
      for (int c = tx; c < D; c += 16)
        acc = fmaf(sg[r * kDP + c], ld(ob + (long long)(q0 + r) * st.o[2] + c),
                   acc);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    delta[i] = acc;
  }

  int first, last;
  key_tiles(q0, s, causal, window, &first, &last);

  // pass 1: each row's logsumexp, online as the forward
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  for (int it = first; it < last; ++it) {
    const int k0 = it * kB;
    __syncthreads();
    load_tile<T, D>(sk, kb, st.k[2], k0, s, 1.0f);
    __syncthreads();
    float sc[4][4];
    tile_dots<D>(sq, sk, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(qpos, k0 + tx + 16 * j, s, causal, window))
          sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sum += sc[i][j] > 0.5f * kNegInf ? expf(sc[i][j] - m_new) : 0.0f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = expf(m[i] - m_new) * l[i] + sum;
      m[i] = m_new;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lse[i] = l[i] > 0.0f ? m[i] + logf(l[i]) : 0.0f;

  // pass 2: dS and dQ += dS K
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  for (int it = first; it < last; ++it) {
    const int k0 = it * kB;
    __syncthreads();  // the previous tile's dS and keys are read
    load_tile<T, D>(sk, kb, st.k[2], k0, s, 1.0f);
    load_tile<T, D>(sv, vb, st.v[2], k0, s, 1.0f);
    __syncthreads();
    float sc[4][4], dp[4][4];
    tile_dots<D>(sq, sk, ty, tx, sc);
    tile_dots<D>(sg, sv, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(qpos, k0 + tx + 16 * j, s, causal, window)
                            ? expf(sc[i][j] - lse[i])
                            : 0.0f;
        sp[(ty + 16 * i) * kPS + tx + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();
    const int valid = min(kB, s - k0);
    for (int c = 0; c < valid; ++c) {
      float ds[4], kk[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sp[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) kk[cc] = sk[c * kDP + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[i][cc] = fmaf(ds[i], kk[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s) continue;
    T* out = dq + (((long long)bb * s + r) * h + hh) * D;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      put(out + tx + 16 * cc, acc[i][cc] * sm_scale);
    if (tx == 0) {
      const long long row = ((long long)bb * h + hh) * s + r;
      lse_out[row] = lse[i];
      delta_out[row] = delta[i];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ pk, float* __restrict__ pv,
                            Strides st, int h, int kv, int s, int causal,
                            int window, float sm_scale) {
  using L = Layout<D>;
  constexpr int kDP = L::kDP;
  constexpr int kPS = L::kPS;
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + L::kTile;
  float* sq = sv + L::kTile;   // q * sm_scale
  float* sg = sq + L::kTile;   // dO
  float* sp = sg + L::kTile;   // P, (query, key)
  float* sd = sp + L::kP;      // dS, (query, key)
  float* slse = sd + L::kP;
  float* sdelta = slse + kB;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kB;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (h / kv);
  load_tile<T, D>(sk, k + bb * st.k[0] + kvh * st.k[1], st.k[2], k0, s, 1.0f);
  load_tile<T, D>(sv, v + bb * st.v[0] + kvh * st.v[1], st.v[2], k0, s, 1.0f);

  // the query tiles that see this key tile: [qt_first, qt_last)
  const int nt = (s + kB - 1) / kB;
  const int k_last = min(k0 + kB, s) - 1;
  const int qt_first = causal ? k0 / kB : 0;
  const int qt_last =
      window > 0 ? min(nt, (k_last + window - 1) / kB + 1) : nt;

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc_k[i][c] = 0.0f;
      acc_v[i][c] = 0.0f;
    }

  const T* qb = q + bb * st.q[0] + hh * st.q[1];
  const T* gb = g + bb * st.g[0] + hh * st.g[1];
  const long long row0 = ((long long)bb * h + hh) * s;
  for (int qt = qt_first; qt < qt_last; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // the previous tile's P, dS, q and dO are read
    load_tile<T, D>(sq, qb, st.q[2], q0, s, sm_scale);
    load_tile<T, D>(sg, gb, st.g[2], q0, s, 1.0f);
    if (tid < kB) {
      const bool in = q0 + tid < s;
      slse[tid] = in ? lse[row0 + q0 + tid] : 0.0f;
      sdelta[tid] = in ? delta[row0 + q0 + tid] : 0.0f;
    }
    __syncthreads();
    float sc[4][4], dp[4][4];
    tile_dots<D>(sq, sk, ty, tx, sc);
    tile_dots<D>(sg, sv, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, s, causal, window)
                            ? expf(sc[i][j] - slse[r])
                            : 0.0f;
        sp[r * kPS + c] = p;
        sd[r * kPS + c] = p * (dp[i][j] - sdelta[r]);
      }
    }
    __syncthreads();
    const int valid = min(kB, s - q0);
    for (int r = 0; r < valid; ++r) {
      float pv_[4], dsv[4], gg[kCols], qq[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv_[i] = sp[r * kPS + ty + 16 * i];
        dsv[i] = sd[r * kPS + ty + 16 * i];
      }
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        gg[cc] = sg[r * kDP + tx + 16 * cc];
        qq[cc] = sq[r * kDP + tx + 16 * cc];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          acc_v[i][cc] = fmaf(pv_[i], gg[cc], acc_v[i][cc]);
          acc_k[i][cc] = fmaf(dsv[i], qq[cc], acc_k[i][cc]);
        }
    }
  }

  // this head's shares, (B, S, H, D) float32
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= s) continue;
    const long long base = (((long long)bb * s + r) * h + hh) * D;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      pk[base + tx + 16 * cc] = acc_k[i][cc];
      pv[base + tx + 16 * cc] = acc_v[i][cc];
    }
  }
}

// dK, dV (B, S, KV, D) = the sum of the group's H / KV shares, in order
template <typename T>
__global__ void flash_attention_bwd_reduce(const float* __restrict__ pk,
                                           const float* __restrict__ pv,
                                           T* __restrict__ dk,
                                           T* __restrict__ dv,
                                           long long n, int h, int kv,
                                           int d) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int c = (int)(e % d);
  const long long row = e / d;        // (b, s, key head)
  const int kvh = (int)(row % kv);
  const long long bs = row / kv;
  const int group = h / kv;
  const long long src = (bs * h + (long long)kvh * group) * d + c;
  float a = 0.0f, b = 0.0f;
  for (int gi = 0; gi < group; ++gi) {
    a += pk[src + (long long)gi * d];
    b += pv[src + (long long)gi * d];
  }
  put(dk + e, a);
  put(dv + e, b);
}

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, const T* o, const T* g, T* dq,
           T* dk, T* dv, float* lse, float* delta, float* pk, float* pv,
           const Strides& st, int b, int h, int kv, int s, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  using L = Layout<D>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_bwd_dq<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytesDq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_attention_bwd_dkv<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)L::kBytesDkv);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (s + kB - 1) / kB;
  flash_attention_bwd_dq<T, D><<<dim3(tiles, h, b), kThreads, L::kBytesDq,
                                 stream>>>(q, k, v, o, g, dq, lse, delta, st,
                                           h, kv, s, causal, window,
                                           sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_attention_bwd_dkv<T, D><<<dim3(tiles, h, b), kThreads, L::kBytesDkv,
                                  stream>>>(q, k, v, g, lse, delta, pk, pv,
                                            st, h, kv, s, causal, window,
                                            sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)b * s * kv * D;
  flash_attention_bwd_reduce<T><<<(unsigned)((n + 255) / 256), 256, 0,
                                  stream>>>(pk, pv, dk, dv, n, h, kv, D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* g, void* dq, void* dk, void* dv, float* lse,
             float* delta, float* pk, float* pv, const long long* st, int b,
             int h, int kv, int s, int d, int causal, int window,
             float sm_scale, void* stream) {
  if (b == 0 || h == 0 || s == 0) return 0;
  if (kv <= 0 || h % kv != 0 || b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  Strides str;
  for (int i = 0; i < 3; ++i) {
    str.q[i] = st[i];
    str.k[i] = st[3 + i];
    str.v[i] = st[6 + i];
    str.o[i] = st[9 + i];
    str.g[i] = st[12 + i];
  }
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* to = static_cast<const T*>(o);
  const T* tg = static_cast<const T*>(g);
  T* tdq = static_cast<T*>(dq);
  T* tdk = static_cast<T*>(dk);
  T* tdv = static_cast<T*>(dv);
  cudaStream_t cs = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return launch<T, 64>(tq, tk, tv, to, tg, tdq, tdk, tdv, lse, delta,
                           pk, pv, str, b, h, kv, s, causal, window,
                           sm_scale, cs);
    case 128:
      return launch<T, 128>(tq, tk, tv, to, tg, tdq, tdk, tdv, lse, delta,
                            pk, pv, str, b, h, kv, s, causal, window,
                            sm_scale, cs);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o, dO: the forward's (B, H, S, D) / (B, KV, S, D) views, with
// st their 15 element strides (q, k, v, o, dO; batch, head, position);
// dq (B, S, H, D), dk, dv (B, S, KV, D) contiguous, in the inputs' dtype;
// float32 scratch: lse, delta of B * H * S, pk, pv of B * S * H * D.
// Returns cudaGetLastError().
extern "C" int flash_attention_bwd_f32_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, void* dq, void* dk, void* dv, float* lse, float* delta,
    float* pk, float* pv, const long long* st, int b, int h, int kv, int s,
    int d, int causal, int window, float sm_scale, void* stream) {
  return dispatch<float>(q, k, v, o, g, dq, dk, dv, lse, delta, pk, pv, st,
                         b, h, kv, s, d, causal, window, sm_scale, stream);
}

extern "C" int flash_attention_bwd_bf16_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, void* dq, void* dk, void* dv, float* lse, float* delta,
    float* pk, float* pv, const long long* st, int b, int h, int kv, int s,
    int d, int causal, int window, float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, g, dq, dk, dv, lse, delta, pk,
                                 pv, st, b, h, kv, s, d, causal, window,
                                 sm_scale, stream);
}
