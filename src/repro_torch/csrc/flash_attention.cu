// Causal GQA flash attention, forward, with an optional sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (body _kernel): for query head h of batch b,
//   out = softmax(q k^T * sm_scale + mask) v
// over key head h * KV / H, where the mask keeps kpos < S, kpos <= qpos
// when causal, and kpos > qpos - window when window > 0. Scores, the
// online-softmax statistics and the accumulator are float32; q, k, v and
// out are float32 or bfloat16 (out in q's dtype).
//
// Bound on the H100 at the serve path's prompt shape (B, S, H, KV, D) =
// (8, 512, 12, 2, 128) in bf16: the function must read q, k, v and write
// out once, 29.4 MB, 8.8 us at 3.35 TB/s; causal attention needs
// 4 * B * H * D * S (S + 1) / 2 = 6.46 GFLOP, 6.5 us on the bf16 tensor
// cores (989 TFLOP/s) and 96 us in float32 outside them (67 TFLOP/s).
// This kernel computes in float32 on the CUDA cores, so its floor is the
// float32 one; tensor cores (wgmma), TMA and a pipelined ring of tiles
// are later work.
//
// Design: one block of 256 threads (16 x 16) per (query tile of 64 rows,
// head, batch). The query tile, pre-scaled by sm_scale as the TPU kernel
// does, stays in shared memory; the block walks the key tiles of 64 rows
// in order, skipping tiles wholly in the future (causal) or wholly out of
// the window, as the TPU kernel skips them. Thread (ty, tx) owns query
// rows ty + 16 i and key columns tx + 16 j (i, j < 4), so a row's 16
// owners are one half-warp and its max and sum reduce with four
// shuffles. Scores are read from float4 rows padded by 4 floats (no bank
// conflicts across the 16 key rows a half-warp reads). The probabilities
// of a tile overwrite its keys in shared memory, so a block needs
// 98 KB at D = 128 and two blocks fit an SM. The ragged tail of S is
// masked with kpos < S and its rows are zero-filled.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // key rows a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Layout {
  static constexpr int kDP = D + 4;                 // padded row stride
  static constexpr int kPS = kBK + 1;               // probability row stride
  static constexpr int kQ = kBQ * kDP;
  static constexpr int kKP = (kBK * kDP > kBQ * kPS) ? kBK * kDP : kBQ * kPS;
  static constexpr int kV = kBK * D;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKP + kV);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int h, int kv, int s, int causal, int window,
                           float sm_scale) {
  using L = Layout<D>;
  constexpr int kDP = L::kDP;
  constexpr int kPS = L::kPS;
  constexpr int kCols = D / 16;  // output columns a thread owns
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // kBQ x kDP, scaled q
  float* sk = sq + L::kQ;                       // kBK x kDP keys, then
  float* sp = sk;                               // kBQ x kPS probabilities
  float* sv = sk + L::kKP;                      // kBK x D values

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh * kv / h;
  const T* qb = q + ((long long)bb * h + hh) * s * D;
  const T* kb = k + ((long long)bb * kv + kvh) * s * D;
  const T* vb = v + ((long long)bb * kv + kvh) * s * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const float x = (q0 + r < s) ? to_f32(qb[(long long)(q0 + r) * D + c])
                                 : 0.0f;
    sq[r * kDP + c] = x * sm_scale;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = q0 + kBQ - 1;
  const int num_tiles = (s + kBK - 1) / kBK;
  for (int it = 0; it < num_tiles; ++it) {
    const int k0 = it * kBK;
    if (causal && k0 > q_last) break;                       // future
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;  // past window
    __syncthreads();  // the previous tile's probabilities and values read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < s;
      const long long g = (long long)(k0 + r) * D + c;
      sk[r * kDP + c] = in ? to_f32(kb[g]) : 0.0f;
      sv[r * D + c] = in ? to_f32(vb[g]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&sq[(ty + 16 * i) * kDP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&sk[(tx + 16 * j) * kDP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          sc[i][j] = a;
        }
    }

    // mask, then the online-softmax update of each owned row
    float p[4][4], alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < s && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        if (!ok[j]) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(sc[i][j] - m_new) : 0.0f;
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();  // every thread has read the keys: reuse them for p
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sp[(ty + 16 * i) * kPS + tx + 16 * j] = p[i][j];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha[i];
    const int valid = min(kBK, s - k0);
    for (int c = 0; c < valid; ++c) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) vv[cc] = sv[c * D + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

  T* ob = out + ((long long)bb * h + hh) * s * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      store(&ob[(long long)r * D + tx + 16 * cc], acc[i][cc] * inv);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* out, int b, int h,
             int kv, int s, int causal, int window, float sm_scale,
             cudaStream_t stream) {
  const size_t bytes = Layout<D>::kBytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((s + kBQ - 1) / kBQ, h, b);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, h, kv, s, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int b, int h, int kv,
           int s, int d, int causal, int window, float sm_scale,
           void* stream) {
  if (b == 0 || h == 0 || s == 0) return 0;
  if (kv <= 0 || h % kv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return launch_d<T, 64>(q, k, v, out, b, h, kv, s, causal, window,
                             sm_scale, st);
    case 128:
      return launch_d<T, 128>(q, k, v, out, b, h, kv, s, causal, window,
                              sm_scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_f32_launch(const float* q, const float* k,
                                          const float* v, float* out, int b,
                                          int h, int kv, int s, int d,
                                          int causal, int window,
                                          float sm_scale, void* stream) {
  return launch<float>(q, k, v, out, b, h, kv, s, d, causal, window,
                       sm_scale, stream);
}

extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* out, int b,
                                           int h, int kv, int s, int d,
                                           int causal, int window,
                                           float sm_scale, void* stream) {
  using B = __nv_bfloat16;
  return launch<B>(static_cast<const B*>(q), static_cast<const B*>(k),
                   static_cast<const B*>(v), static_cast<B*>(out), b, h, kv,
                   s, d, causal, window, sm_scale, stream);
}
