// Causal GQA flash attention, forward, with an optional sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (body _kernel; pl.pallas_call at :108): for
// query head h of batch b,
//   out = softmax(q k^T * sm_scale + mask) v
// over key head h * KV / H, where the mask keeps kpos < S, kpos <= qpos
// when causal, and kpos > qpos - window when window > 0; key tiles wholly
// in the future or wholly out of the window are skipped, and the output
// is divided by max(l, 1e-30). Scores, the online-softmax statistics and
// the accumulator are float32.
//
// Layout: q (B, H, S, D) and k, v (B, KV, S, D) are strided views (the
// last dim unit-stride, the others multiples of 8 elements), so the
// model's (B, S, H, D) tensors come in transposed without a copy; out
// is written in the model's layout, (B, S, H, D) contiguous.
//
// Bound on the H100 at the serve path's prompt shapes, bf16, causal:
// qwen2-1.5b's (B, S, H, KV, D) = (8, 512, 12, 2, 128) must read q, k, v
// and write out once, 29.4 MB, 8.764 us at 3.35 TB/s, and needs
// 4 * B * H * D * S (S + 1) / 2 = 6.46 GFLOP, 6.5 us on the bf16 tensor
// cores (989 TFLOP/s); mixtral-8x22b's (8, 512, 48, 8, 128) moves 117.4
// MB, 35.057 us (bytes; its 25.8 GFLOP take 26.1 us). So the kernel has
// to run its products on the tensor cores and keep its loads in flight
// behind them; beyond that it is bytes-bound.
//
// bf16 design (flash_attention_wgmma, D = 64 or 128):
//  - A block is one warpgroup (128 threads) owning kBM = 64 query rows of
//    one (batch, head); key tiles are kBK = 64 rows. Grid (H, B, query
//    tiles) with the query tile reversed, so the longest causal rows (the
//    last tiles) start first, across every head. The tile was chosen by
//    measurement on an H100 at qwen2's prompt (PERF.md): (64, 64) ran in
//    39.4-39.8 us against 43.6-44.6 us for two warpgroups a block sharing
//    64-row K/V tiles and 45.8-46.5 us with 128-row key tiles. At D = 128
//    the block takes 83,008 bytes of shared memory and 167 registers a
//    thread, so two blocks share an SM and one's softmax overlaps the
//    other's products; two warpgroups in one block run in lock-step and
//    idle the tensor cores together.
//  - TMA loads q's 64 x D tile once and the K and V tiles into a ring of
//    two stages, each stage completing on an mbarrier; thread 0 starts
//    tile t + 2's copy into a stage as soon as the block is done with
//    tile t, so the copy of the next tile overlaps this tile's products.
//    128-byte swizzle: a row of 64 bf16 is one 128-byte line, eight
//    lines one 1024-byte swizzle atom, and D = 128 is two such column
//    blocks, each its own TMA box and smem region. Rows past S come back
//    zero-filled; kpos < S is still masked (a zero key scores 0, not
//    -inf).
//  - S = Q K^T: wgmma m64 n64 k16, both operands K-major from shared
//    memory, descriptors with the same 128-byte swizzle (start address
//    advanced by 32 bytes a k16 step inside an atom, SBO 1024 bytes).
//    sm_scale * log2(e) multiplies the float32 scores; q is never
//    rescaled or rounded.
//  - The online softmax runs in the accumulator's registers: a thread
//    holds rows 16 warp + lane / 4 and + 8, a row's 4 owners are one
//    quad (max by __shfl_xor_sync over lanes 1 and 2; l is summed per
//    thread and reduced once at the end). The block's range of key
//    tiles leaves out the tiles wholly in its future or wholly out of
//    its window; of the rest, only tiles that cross the diagonal, the
//    window's edge or S are masked.
//  - O += P V: the float32 accumulator layout of S is the register
//    A-fragment layout of the next product, so P never goes to shared
//    memory. P is split as P_hi = bf16(P), P_lo = bf16(P - P_hi) and
//    both are multiplied by the same V tile, so P keeps ~16 bits. One
//    bf16 rounding of P alone errs by up to 2^-9 of each term, on top of
//    the output's own rounding, which for outputs in [4, 8) already
//    reaches the 2^-6 gate. V is the B operand MN-major
//    (D contiguous), wgmma's transpose bit, one m64 n64 k16 per 64
//    columns of D.
//  - wgmma.fence before each product group (its accumulator or A
//    registers were written by ordinary instructions), commit, then
//    wait_group 0 before any register of the group is read.
//
// float32 (flash_attention_f32): scalar, for checks at 1e-5 that TF32
// tensor cores cannot meet. One block of 256 threads
// (16 x 16) per (query tile of 64 rows, head, batch); the query tile,
// pre-scaled by sm_scale as the TPU kernel does, stays in shared
// memory; key tiles of 64 rows in order, skipping future and
// out-of-window tiles; thread (ty, tx) owns query rows ty + 16 i and key
// columns tx + 16 j, so a row's 16 owners are one half-warp and its max
// and sum reduce with four shuffles; the probabilities overwrite the
// keys in shared memory (98 KB at D = 128).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// element strides of q, k, v over (batch, head, position)
struct Strides {
  long long q[3], k[3], v[3];
};

// ---------------------------------------------------------------------------
// float32: scalar kernel

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK32 = 64;      // key rows a tile
constexpr int kThreads = 256;  // 16 x 16

template <int D>
struct Layout {
  static constexpr int kDP = D + 4;                 // padded row stride
  static constexpr int kPS = kBK32 + 1;             // probability row stride
  static constexpr int kQ = kBQ * kDP;
  static constexpr int kKP = (kBK32 * kDP > kBQ * kPS) ? kBK32 * kDP
                                                       : kBQ * kPS;
  static constexpr int kV = kBK32 * D;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKP + kV);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        Strides st, int h, int kv, int s, int causal,
                        int window, float sm_scale) {
  using L = Layout<D>;
  constexpr int kDP = L::kDP;
  constexpr int kPS = L::kPS;
  constexpr int kBK = kBK32;
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
  const float* qb = q + bb * st.q[0] + hh * st.q[1];
  const float* kb = k + bb * st.k[0] + kvh * st.k[1];
  const float* vb = v + bb * st.v[0] + kvh * st.v[1];

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const float x = (q0 + r < s) ? qb[(q0 + r) * st.q[2] + c] : 0.0f;
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
      sk[r * kDP + c] = in ? kb[(k0 + r) * st.k[2] + c] : 0.0f;
      sv[r * D + c] = in ? vb[(k0 + r) * st.v[2] + c] : 0.0f;
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

  // out (B, S, H, D)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s) continue;
    float* o = out + (((long long)bb * s + r) * h + hh) * D;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) o[tx + 16 * cc] = acc[i][cc] * inv;
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* out,
               const Strides& st, int b, int h, int kv, int s, int causal,
               int window, float sm_scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((s + kBQ - 1) / kBQ, h, b);
  flash_attention_f32<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, st, h, kv, s, causal, window, sm_scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: wgmma + TMA kernel

constexpr int kBM = 64;           // query rows a block: one warpgroup
constexpr int kBK = 64;           // key rows a tile
constexpr int kWgThreads = 128;
constexpr int kStages = 2;        // K/V ring
constexpr int kLine = 128;        // bytes of one swizzled row (64 bf16)
constexpr int kAtom = 1024;       // 8 lines: one 128-byte swizzle atom

template <int D>
struct WgLayout {
  static constexpr int kChunks = D / 64;          // 64-column blocks of D
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kBarOff = kQBytes + 2 * kStages * kTileBytes;
  static constexpr size_t kBytes = kBarOff + 64 + kAtom;  // + alignment
};

// thread 0: K and V tile j_lo + t into stage t % kStages
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint8_t* sk,
                                        uint8_t* sv, uint64_t* full, int t,
                                        int j_lo, int kvh, int bb) {
  constexpr int kTileBytes = WgLayout<D>::kTileBytes;
  const int stage = t % kStages;
  mbar_expect_tx(&full[stage], 2 * kTileBytes);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    const int off = stage * kTileBytes + c * kBK * kLine;
    tma_load(sk + off, tk, &full[stage], 64 * c, (j_lo + t) * kBK, kvh, bb);
    tma_load(sv + off, tv, &full[stage], 64 * c, (j_lo + t) * kBK, kvh, bb);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_attention_wgmma(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          __nv_bfloat16* __restrict__ out, int h, int kv,
                          int s, int causal, int window, float scale_log2) {
  using L = WgLayout<D>;
  constexpr int kC = L::kChunks;
  constexpr int kNS = kBK / 2;  // S accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAtom - 1) &
      ~uintptr_t(kAtom - 1));
  uint8_t* sq = smem;                            // [chunk][kBM rows][128 B]
  uint8_t* sk = smem + L::kQBytes;               // [stage][chunk][kBK][128 B]
  uint8_t* sv = sk + kStages * L::kTileBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* qbar = bar;
  uint64_t* full = bar + 1;                      // one a stage

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // longest first
  const int kvh = hh / (h / kv);

  // key tiles [j_lo, j_hi): none wholly in the block's future or wholly
  // out of its window
  const int q_last = min(q0 + kBM, s) - 1;
  const int nk = (s + kBK - 1) / kBK;
  const int j_hi = causal ? min(nk, q_last / kBK + 1) : nk;
  const int j_lo = (window > 0 && q0 - window + 1 > 0)
                       ? (q0 - window + 1) / kBK : 0;
  const int n_tiles = j_hi - j_lo;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, L::kQBytes);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      tma_load(sq + c * kBM * kLine, &tq, qbar, 64 * c, q0, hh, bb);
    for (int t = 0; t < kStages && t < n_tiles; ++t)
      load_kv<D>(&tk, &tv, sk, sv, full, t, j_lo, kvh, bb);
  }

  // a thread's rows ra and ra + 8
  const int ra = q0 + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);  // first of a thread's two columns
  const uint32_t sq_a = smem_u32(sq);
  const uint32_t sk_a = smem_u32(sk);
  const uint32_t sv_a = smem_u32(sv);

  float sacc[kNS];
  float o[kC][32];
#pragma unroll
  for (int i = 0; i < kNS; ++i) sacc[i] = 0.0f;
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};   // this thread's share of the row sums

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    const int k0 = (j_lo + t) * kBK;
    mbar_wait(&full[stage], (t / kStages) & 1);
    const uint32_t k_a = sk_a + stage * L::kTileBytes;
    const uint32_t v_a = sv_a + stage * L::kTileBytes;
    // S = Q K^T
    pin(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // inside a 128-byte line
      const uint64_t da = sw128_desc(
          sq_a + (kk / 4) * kBM * kLine + col, 16, kAtom);
      const uint64_t db = sw128_desc(
          k_a + (kk / 4) * kBK * kLine + col, 16, kAtom);
      wgmma_ss_n64(sacc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sacc);

    // mask (edge tiles only), scale, online softmax
    const bool edge = (k0 + kBK > s) || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kBM - 1 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      float x = sacc[i] * scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
        const int qpos = ra + ((i & 2) ? 8 : 0);
        const bool ok = kpos < s && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        if (!ok) x = kNegInf;
      }
      sacc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with every key so far masked keeps p = 0 (not exp2(0))
      mb[r] = (m_new == kNegInf) ? 0.0f : m_new;
      alpha[r] = exp2f(m[r] - mb[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    uint32_t phi[kBK / 16][4], plo[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int rg = 0; rg < 4; ++rg) {
        // A fragment register rg of k16 step kk: S block 2 kk + rg / 2,
        // row ra (+ 8 when rg is odd), columns cq, cq + 1
        const int i = 4 * (2 * kk + (rg >> 1)) + 2 * (rg & 1);
        const int r = rg & 1;
        const float p0 = exp2f(sacc[i] - mb[r]);
        const float p1 = exp2f(sacc[i + 1] - mb[r]);
        l[r] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            p0 - __low2float(hi), p1 - __high2float(hi));
        phi[kk][rg] = bf16x2_bits(hi);
        plo[kk][rg] = bf16x2_bits(lo);
      }
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

    // O += P_hi V + P_lo V
#pragma unroll
    for (int c = 0; c < kC; ++c) pin(o[c]);
    pin(phi);
    pin(plo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const uint64_t db = sw128_desc(
            v_a + c * kBK * kLine + kk * 2 * kAtom, kAtom, kAtom);
        wgmma_rs_n64_tb(o[c], phi[kk], db);
        wgmma_rs_n64_tb(o[c], plo[kk], db);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kC; ++c) pin(o[c]);
    pin(phi);
    pin(plo);
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && t + kStages < n_tiles)
      load_kv<D>(&tk, &tv, sk, sv, full, t + kStages, j_lo, kvh, bb);
  }

  // out (B, S, H, D): rows ra and ra + 8, divided by max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= s) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* ob = out + (((long long)bb * s + row) * h + hh) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(ob + 64 * c + 8 * j + cq) =
            __floats2bfloat162_rn(o[c][i] * inv, o[c][i + 1] * inv);
      }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 const Strides& st, int b, int h, int kv, int s, int causal,
                 int window, float sm_scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  constexpr CUtensorMapDataType kBf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int code = make_map(&tq, q, kBf, 2, D, s, h, b, st.q, 64, kBM);
  if (code == 0) code = make_map(&tk, k, kBf, 2, D, s, kv, b, st.k, 64, kBK);
  if (code == 0) code = make_map(&tv, v, kBf, 2, D, s, kv, b, st.v, 64, kBK);
  if (code != 0) return code;
  constexpr size_t bytes = WgLayout<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(h, b, (s + kBM - 1) / kBM);
  const float scale_log2 = (float)((double)sm_scale * 1.4426950408889634);
  flash_attention_wgmma<D><<<grid, kWgThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), h, kv, s, causal,
      window, scale_log2);
  return (int)cudaGetLastError();
}

Strides strides_of(const long long* st) {
  Strides r;
  for (int i = 0; i < 3; ++i) {
    r.q[i] = st[i];
    r.k[i] = st[3 + i];
    r.v[i] = st[6 + i];
  }
  return r;
}

}  // namespace

// st: element strides (batch, head, position) of q, then k, then v; the
// last dim of each is unit-stride. out is (B, S, H, D) contiguous.
extern "C" int flash_attention_f32_launch(const float* q, const float* k,
                                          const float* v, float* out,
                                          const long long* st, int b, int h,
                                          int kv, int s, int d, int causal,
                                          int window, float sm_scale,
                                          void* stream) {
  if (b == 0 || h == 0 || s == 0) return 0;
  if (kv <= 0 || h % kv != 0) return (int)cudaErrorInvalidValue;
  const Strides str = strides_of(st);
  cudaStream_t cs = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return launch_f32<64>(q, k, v, out, str, b, h, kv, s, causal, window,
                            sm_scale, cs);
    case 128:
      return launch_f32<128>(q, k, v, out, str, b, h, kv, s, causal, window,
                             sm_scale, cs);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           const long long* st, int b, int h,
                                           int kv, int s, int d, int causal,
                                           int window, float sm_scale,
                                           void* stream) {
  if (b == 0 || h == 0 || s == 0) return 0;
  if (kv <= 0 || h % kv != 0 || b > 65535 || (s + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides str = strides_of(st);
  cudaStream_t cs = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return launch_wgmma<64>(q, k, v, out, str, b, h, kv, s, causal,
                              window, sm_scale, cs);
    case 128:
      return launch_wgmma<128>(q, k, v, out, str, b, h, kv, s, causal,
                               window, sm_scale, cs);
  }
  return (int)cudaErrorInvalidValue;
}

// bytes of dynamic shared memory the bf16 kernel launches with at head
// dim d, or -1
extern "C" int flash_attention_bf16_smem(int d) {
  switch (d) {
    case 64:
      return (int)WgLayout<64>::kBytes;
    case 128:
      return (int)WgLayout<128>::kBytes;
  }
  return -1;
}
