// RWKV6 WKV recurrence (exclusive convention with the u bonus), forward.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py,
// rwkv6_scan_kernel (body _kernel; pl.pallas_call at :72): for every
// (batch, head), from C_0 = 0,
//   y_t = r_t . C_{t-1} + (r_t . (u o k_t)) v_t
//   C_t = diag(exp(log_w_t)) C_{t-1} + k_t v_t^T
// with r, k, v (T, 64) in float32 or bfloat16, log_w (T, 64) <= 0 and u
// (64,) float32. It returns y (T, 64) and the final state C_T (64, 64),
// both float32, for any T >= 1.
//
// Layout: r, k, v and log_w are strided (B, H, T, 64) views (unit-stride
// last dim; in bf16, read through TMA, the other strides and the base
// 16-byte aligned), so the model's (B, T, H, 64) tensors come in
// transposed without a copy; y is
// written in the model's layout, (B, T, H, 64) contiguous.
//
// Bound on the H100 at the serve path's prompt shape (B, H, T, dk, dv) =
// (8, 32, 512, 64, 64), bf16 r/k/v: the function must read r, k, v
// (50.3 MB), log_w (33.6 MB) and write y (33.6 MB) and the final state
// (4.2 MB), 121.6 MB, 36.3 us at 3.35 TB/s; bytes bound it. The chunked
// form below runs its products on the tensor cores (~12.5 GFLOP a call
// in split operands, ~17 us at the TF32 and bf16 peaks) and ~55 M exp2 on
// the SFUs (~13 us), in 8 dependent chunks a (batch, head) on 256
// blocks: two waves of one 16-warp block an SM (220 KB of shared memory
// each), so a
// chunk's phases run at low issue rate on their latencies (PERF.md).
//
// bf16 design (rwkv6_scan_chunked): the chunked form of the TPU kernel,
// with no decay factor above 1.
//  - One block of 4 warpgroups per (batch, head) walks the chunks of 64
//    steps in order. Thread 0 starts chunk c + 1's TMA loads of r, k, v
//    (bf16) and log_w (float) into the other stage of a two-stage ring as
//    chunk c starts (rows past T come back zero: r = k = v = 0, log_w =
//    0 leave y and the state as they are); a "full" mbarrier a stage.
//    The model's strided (B, T, H, 64) views are read through 4-D tensor
//    maps, no copy.
//  - Decays, in log2 units, referenced so that no factor exceeds 1. Each
//    thread scans one (16-row sub-chunk I, channel) column: the inclusive
//    prefix incl_i (e_i = incl_{i-1}, the exclusive one) and the total
//    T_I. Then
//      q~_i = r_i 2^e_i,  k~_j = k_j 2^(T_I - incl_j),
//      the chunk-start query  q~_i 2^(T_0 + .. + T_{I-1}),
//      the chunk-end key      k~_j 2^(T_{J+1} + .. + T_3),
//      the score of i in I and j in an earlier J
//        sum_c q~_ic k~_jc 2^(T_{J+1} + .. + T_{I-1}),
//    i.e. both factors of a score are referenced at the boundary before
//    sub-chunk I (the secondary chunking of Gated Linear Attention,
//    arXiv:2312.06635). Every exponent is a sum over its own interval.
//  - Inside a sub-chunk the same once more at its halves: i in rows 8-15
//    against j in rows 0-7 is sum_c (r_ic 2^(e_ic - incl_7c))
//    (k_jc 2^(incl_7c - incl_jc)), a tensor-core tile; pairs inside one
//    half (j < i) take the exact pairwise decay 2^(e_i - incl_j) on CUDA
//    cores, 56 pairs x 64 channels a sub-chunk; the diagonal (j = i) is
//    the u bonus, sum_c r_ic u_c k_ic. So y_intra = A V with A lower
//    triangular.
//  - Precision (the bar is 1e-4 of max(1, |value|)): a product with an
//    inexact operand splits it. TF32 products split x = hi + lo (hi
//    rounded to TF32, lo = x - hi read as TF32: 21-22 bits) and sum
//    hi.hi + hi.lo + lo.hi; bf16 products against the exact bf16 v split
//    the other side in three bf16 pieces (24 bits). A bf16 hi/lo split
//    (16 bits) erred by 1.1-3.0e-4 in a float64 emulation at the prompt's
//    decays (tools/rwkv6_split_emulation.py).
//  - Per chunk, between block barriers:
//    the decays (every thread, 8 rows of one column);
//    phase S: the in-half pairs and the bonus on CUDA cores, one lane
//    each; warpgroup J < 3 the scores of every row against the keys of
//    sub-chunk J (wgmma m64 n16 k8, TF32, A = q~ 2^(...) in registers,
//    B = k~ hi / lo from shared memory); warpgroup 3 the half-against-half
//    tiles (mma.sync m16 n8 k8, TF32);
//    phase Y/U: warpgroups 0 and 2 each half of y = q S + A V (q S over
//    32 channels, wgmma m64 n64 k8 TF32 against the state's transpose hi
//    / lo; A V over 32 keys, wgmma m64 n64 k16 bf16 against v, MN-major);
//    warpgroups 1 and 3 each half of the keys of k^T V (wgmma m64 n64
//    k16 bf16); warpgroup 1 adds both halves to S 2^ltot in float32 and
//    writes the state's transpose, hi and lo, the next chunk's B operand
//    and where the state lives between chunks (hi + lo is it exactly).
//    Every loop of wgmma builds the next step's A fragment while the
//    last step runs. The wgmma operands in shared memory are in the
//    128-byte swizzle, as TMA writes them.
//
// float32 (rwkv6_scan_seq): the sequential recurrence, for checks at 1e-5
// that split TF32 or bf16 products would need r, k and v split as well.
// One block of 256 threads per (batch, head); thread (g, j) holds rows
// 16 g .. 16 g + 15 of column j of the state in registers; 16 steps of r,
// k, exp(log_w) and v are staged in shared memory at a time and walked in
// order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;  // dk = dv

// element strides (batch, head, position) of r, k, v and log_w
struct Strides {
  long long r[3], k[3], v[3], w[3];
};

// ---------------------------------------------------------------------------
// float32: sequential kernel

constexpr int kGroups = 4;     // row groups of the state
constexpr int kRows = kD / kGroups;
constexpr int kSeqThreads = kGroups * kD;
constexpr int kSteps = 16;     // steps staged in shared memory at a time

__global__ void __launch_bounds__(kSeqThreads)
    rwkv6_scan_seq(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ log_w,
                   const float* __restrict__ u, float* __restrict__ y,
                   float* __restrict__ fin, Strides st, int h, int t_len) {
  __shared__ float4 sr4[kSteps][kD / 4];
  __shared__ float4 sk4[kSteps][kD / 4];
  __shared__ float4 sw4[kSteps][kD / 4];
  __shared__ float sv[kSteps][kD];
  __shared__ float sy[kGroups][kSteps][kD];
  float* sr = reinterpret_cast<float*>(sr4);
  float* sk = reinterpret_cast<float*>(sk4);
  float* sw = reinterpret_cast<float*>(sw4);

  const int tid = threadIdx.x;
  const int j = tid % kD;
  const int g = tid / kD;
  const int bh = blockIdx.x;  // b * h + head
  const int bb = bh / h, head = bh % h;
  const float* rb = r + bb * st.r[0] + head * st.r[1];
  const float* kb = k + bb * st.k[0] + head * st.k[1];
  const float* vb = v + bb * st.v[0] + head * st.v[1];
  const float* wb = log_w + bb * st.w[0] + head * st.w[1];

  float c[kRows], uu[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    c[i] = 0.0f;
    uu[i] = u[head * kD + g * kRows + i];
  }

  for (int t0 = 0; t0 < t_len; t0 += kSteps) {
    __syncthreads();  // the previous chunk's steps and sums are done
    for (int e = tid; e < kSteps * kD; e += kSeqThreads) {
      const int tt = e / kD, i = e % kD;
      const bool in = t0 + tt < t_len;
      const long long t = t0 + tt;
      sr[e] = in ? rb[t * st.r[2] + i] : 0.0f;
      sk[e] = in ? kb[t * st.k[2] + i] : 0.0f;
      sw[e] = in ? expf(wb[t * st.w[2] + i]) : 1.0f;
      sv[tt][i] = in ? vb[t * st.v[2] + i] : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int tt = 0; tt < kSteps; ++tt) {
      const float vj = sv[tt][j];
      float part[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 r4 = sr4[tt][g * 4 + q];
        const float4 k4 = sk4[tt][g * 4 + q];
        const float4 w4 = sw4[tt][g * 4 + q];
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        float a = 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q * 4 + e;
          const float kv = kk[e] * vj;
          // y reads C_{t-1} plus the u bonus; then C_t replaces it
          a = fmaf(rr[e], fmaf(uu[i], kv, c[i]), a);
          c[i] = fmaf(ww[e], c[i], kv);
        }
        part[q] = a;
      }
      sy[g][tt][j] = (part[0] + part[1]) + (part[2] + part[3]);
    }
    __syncthreads();
    for (int e = tid; e < kSteps * kD; e += kSeqThreads) {
      const int tt = e / kD, jj = e % kD;
      if (t0 + tt < t_len)
        y[(((long long)bb * t_len + t0 + tt) * h + head) * kD + jj] =
            (sy[0][tt][jj] + sy[1][tt][jj]) + (sy[2][tt][jj] + sy[3][tt][jj]);
    }
  }
  float* fb = fin + (long long)bh * kD * kD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) fb[(g * kRows + i) * kD + j] = c[i];
}

// ---------------------------------------------------------------------------
// bf16: chunked tensor-core kernel

constexpr int kC = 64;            // steps a chunk
constexpr int kSub = 16;          // steps a sub-chunk
constexpr int kHalf = kSub / 2;   // its halves
constexpr int kNSub = kC / kSub;
constexpr int kThreads = 512;     // 16 warps: 4 warpgroups
constexpr int kLdW = 68;          // row stride (floats): incl, p, q~
constexpr int kLdA = 72;          // row stride (floats): the scores
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, bytes from a 1024-aligned base. Tiles in the 128-byte
// swizzle: a bf16 64 x 64 tile is 64 rows of 128 bytes, a float one two
// column blocks of 64 rows of 128 bytes (32 floats)
constexpr int kTileV = kC * kD * 2;          // bf16 r, k or v
constexpr int kTileS = kC * kD * 4;          // float
constexpr int kTileW = kC * kLdW * 4;        // padded float
constexpr int kStage = 3 * kTileV + kTileS;  // r, k, v, log_w: one TMA fill
constexpr int kOffKT = 0;                    // k~ hi, lo [j][c], K-major
constexpr int kOffST = kOffKT + 2 * kTileS;  // state^T hi, lo [n][c]
constexpr int kOffStage = kOffST + 2 * kTileS;
constexpr int kOffI = kOffStage + 2 * kStage;
constexpr int kOffP = kOffI + kTileW;
constexpr int kOffQ = kOffP + kTileW;
constexpr int kOffA = kOffQ + kTileW;
constexpr int kOffT = kOffA + kC * kLdA * 4;  // sub-chunk totals [4][64]
constexpr int kOffU = kOffT + kNSub * kD * 4;
constexpr int kOffBar = kOffU + kD * 4;       // full[2]
constexpr int kSmem = kOffBar + 2 * 8 + 1024; // + alignment of the base

// byte offset of element (row, c) of a swizzled bf16 tile
__device__ __forceinline__ int swzb(int row, int c) {
  return row * 128 + ((((c >> 3) ^ row) & 7) << 4) + ((c & 7) << 1);
}
// byte offset of element (row, c) of a swizzled float tile (as a K-major
// wgmma operand: rows are M or N, c is K)
__device__ __forceinline__ int swz(int row, int c) {
  return (c >> 5) * (kC * 128) + row * 128 +
         ((((c & 31) >> 2) ^ (row & 7)) << 4) + ((c & 3) << 2);
}

// generic-proxy accesses of shared memory ordered with the async proxy's
// (TMA writes, wgmma reads)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi rounded to TF32 (round half away, by an integer add and
// a mask: cvt.rna.tf32.f32 takes four instructions), lo = x - hi exactly,
// of which the tensor core reads the TF32 part (its low 13 bits dropped):
// 21-22 significant bits in all
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// (x, y) = p0 + p1 + p2, three bf16 pairs: 24 significant bits
__device__ __forceinline__ void split3(float x, float y, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(x, y);
  const float rx = x - __low2float(h0), ry = y - __high2float(h0);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(rx, ry);
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(rx - __low2float(h1),
                                                  ry - __high2float(h1));
  p0 = bf16x2_bits(h0);
  p1 = bf16x2_bits(h1);
  p2 = bf16x2_bits(h2);
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) b (8 x 8, tf32, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (m64 x n16, f32) += a (registers, tf32) b^T (smem, K-major)
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (m64 x n64, f32) += a (registers, tf32) b^T (smem, K-major)
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

struct Maps {
  CUtensorMap r, k, v, w;
};

// thread 0: chunk rows [t0, t0 + 64) of one (batch, head) into a stage,
// completing on its full barrier; rows past T come back zero
__device__ __forceinline__ void load_chunk(uint8_t* stage, uint64_t* full,
                                           const Maps& m, int t0, int head,
                                           int bb) {
  mbar_expect_tx(full, kStage);
  tma_load(stage, &m.r, full, 0, t0, head, bb);
  tma_load(stage + kTileV, &m.k, full, 0, t0, head, bb);
  tma_load(stage + 2 * kTileV, &m.v, full, 0, t0, head, bb);
  tma_load(stage + 3 * kTileV, &m.w, full, 0, t0, head, bb);
  tma_load(stage + 3 * kTileV + kC * 128, &m.w, full, 32, t0, head, bb);
}

__global__ void __launch_bounds__(kThreads, 1)
    rwkv6_scan_chunked(const __grid_constant__ Maps maps,
                       const float* __restrict__ u, float* __restrict__ y,
                       float* __restrict__ fin, int h, int t_len) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // aligned by an offset into the shared array, so the compiler keeps it
  // in the shared window (plain LDS / STS, not generic loads)
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* sKTh = smem + kOffKT;
  uint8_t* sKTl = sKTh + kTileS;
  uint8_t* sSTh = smem + kOffST;
  uint8_t* sSTl = sSTh + kTileS;
  float* sI = reinterpret_cast<float*>(smem + kOffI);  // incl, [64][kLdW]
  float* sP = reinterpret_cast<float*>(smem + kOffP);  // p, [64][kLdW]
  float* sQ = reinterpret_cast<float*>(smem + kOffQ);  // q~, [64][kLdW]
  float* sA = reinterpret_cast<float*>(smem + kOffA);  // scores [64][kLdA]
  float* sT = reinterpret_cast<float*>(smem + kOffT);  // [4][64] totals
  float* sU = reinterpret_cast<float*>(smem + kOffU);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // fragment thread in group
  const int wg = warp >> 2;  // warpgroup
  const int wi = warp & 3;   // warp in its warpgroup: rows 16 wi ..
  const int bh = blockIdx.x;
  const int bb = bh / h, head = bh % h;
  const int n_chunks = (t_len + kC - 1) / kC;

  if (tid < kD) sU[tid] = u[head * kD + tid];
  for (int e = tid; e < 2 * kTileS / 4; e += kThreads)
    reinterpret_cast<float*>(sSTh)[e] = 0.0f;  // the state from zero
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async();
  __syncthreads();
  if (tid == 0 && n_chunks > 0)
    load_chunk(smem + kOffStage, &full[0], maps, 0, head, bb);

  const uint32_t kth_a = smem_u32(sKTh);
  const uint32_t ktl_a = smem_u32(sKTl);
  const uint32_t sth_a = smem_u32(sSTh);
  const uint32_t stl_a = smem_u32(sSTl);

  for (int n = 0; n < n_chunks; ++n) {
    const int t0 = n * kC;
    const int s = n & 1;
    uint8_t* stage = smem + kOffStage + s * kStage;
    const uint8_t* sr = stage;
    const uint8_t* sk = stage + kTileV;
    const uint32_t v_a = smem_u32(stage + 2 * kTileV);
    const uint8_t* sW = stage + 3 * kTileV;  // log_w
    mbar_wait(&full[s], (n >> 1) & 1);
    fence_async();  // chunk n - 1's reads of the other stage before TMA's
    __syncthreads();   // ... and of the decays and scores before this chunk's
    if (tid == 0 && n + 1 < n_chunks)
      load_chunk(smem + kOffStage + (1 - s) * kStage, &full[1 - s], maps,
                 t0 + kC, head, bb);

    // decays, in log2 units: thread (half h, sub-chunk I, channel c) scans
    // the 16 rows of its column (incl, the inclusive prefix; T_I = incl_15;
    // e, the exclusive one, is incl of the row before) and writes rows
    // 8 h .. 8 h + 7: incl, and
    //   q~ = r 2^e, k~ = k 2^(T_I - incl) (split hi + lo, swizzled: a
    //   wgmma operand; hi + lo is k~ exactly), and p: in the second half
    //   r 2^(e - incl_7), in the first half k 2^(incl_7 - incl)
    {
      const int c = tid & (kD - 1), I = (tid >> 6) & 3, hh = tid >> 8;
      float incl[kSub];
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        acc += *reinterpret_cast<const float*>(sW + swz(kSub * I + q, c)) *
               kLog2e;
        incl[q] = acc;
      }
      if (hh == 0) sT[I * kD + c] = acc;
      // phase-cost cut begin: decays
      const float mid = incl[kHalf - 1];
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        // constant indices into incl (a run-time one puts it in memory)
        const int qq = kHalf * hh + q;
        const int row = kSub * I + qq;
        const float inc = hh ? incl[kHalf + q] : incl[q];
        const float e =
            hh ? incl[kHalf + q - 1] : (q == 0 ? 0.0f : incl[q - 1]);
        const float rr = __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(sr + swzb(row, c)));
        const float kk = __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(sk + swzb(row, c)));
        sI[row * kLdW + c] = inc;
        sQ[row * kLdW + c] = rr * ex2(e);
        uint32_t khi, klo;
        split(kk * ex2(acc - inc), khi, klo);
        *reinterpret_cast<uint32_t*>(sKTh + swz(row, c)) = khi;
        *reinterpret_cast<uint32_t*>(sKTl + swz(row, c)) = klo;
        sP[row * kLdW + c] = hh ? rr * ex2(e - mid) : kk * ex2(mid - inc);
      }
      // phase-cost cut end: decays
    }
    fence_async();
    __syncthreads();

    // phase S (a), CUDA cores: the scores of a pair inside one half of a
    // sub-chunk with the exact pairwise decay 2^(e_i - incl_j) (e_i =
    // incl_{i-1}: i is never a sub-chunk's first row here), two lanes
    // a pair (alternate groups of 4 channels, 16 bytes apart in every
    // tile, 448 lanes), and the diagonal, the u bonus (64 lanes)
    // phase-cost cut begin: pairs
    {
      float acc = 0.0f;
      int ri, rj;
      if (tid < 448) {
        const int pr = tid >> 1, c0 = 4 * (tid & 1);
        const int I = pr / 56, q = pr % 56;
        const int hf = q / 28, qq = q % 28;
        int a = 1;
        while (a * (a + 1) / 2 <= qq) ++a;
        ri = kSub * I + kHalf * hf + a;
        rj = kSub * I + kHalf * hf + qq - a * (a - 1) / 2;
#pragma unroll 4
        for (int c4 = 0; c4 < 8; ++c4) {
          const int c = c0 + 8 * c4;
          const float4 e =
              *reinterpret_cast<const float4*>(sI + (ri - 1) * kLdW + c);
          const float4 w =
              *reinterpret_cast<const float4*>(sI + rj * kLdW + c);
          const uint2 r4 = *reinterpret_cast<const uint2*>(sr + swzb(ri, c));
          const uint2 k4 = *reinterpret_cast<const uint2*>(sk + swzb(rj, c));
          const float2 ra = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&r4.x));
          const float2 rc = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&r4.y));
          const float2 ka = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&k4.x));
          const float2 kc = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&k4.y));
          acc = fmaf(ra.x * ka.x, ex2(e.x - w.x), acc);
          acc = fmaf(ra.y * ka.y, ex2(e.y - w.y), acc);
          acc = fmaf(rc.x * kc.x, ex2(e.z - w.z), acc);
          acc = fmaf(rc.y * kc.y, ex2(e.w - w.w), acc);
        }
      } else {
        ri = rj = tid - 448;
#pragma unroll 8
        for (int c2 = 0; c2 < kD / 2; ++c2) {
          const float2 ra = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sr +
                                                       swzb(ri, 2 * c2)));
          const float2 ka = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sk +
                                                       swzb(rj, 2 * c2)));
          acc = fmaf(ra.x * ka.x, sU[2 * c2], acc);
          acc = fmaf(ra.y * ka.y, sU[2 * c2 + 1], acc);
        }
      }
      const float other = __shfl_xor_sync(0xffffffffu, acc, 1);
      if (tid >= 448) sA[ri * kLdA + rj] = acc;
      else if (!(tid & 1)) sA[ri * kLdA + rj] = acc + other;
    }
    // phase-cost cut end: pairs

    // phase-cost cut begin: scores
    if (wg < 3) {
      // phase S (b), warpgroup J: all rows against the keys of sub-chunk
      // J (wgmma m64 n16 k8, 3xTF32, the next step's A fragment built
      // while the last step runs); the rows of a later sub-chunk I = wi
      // take q~ 2^(T_{J+1} + .. + T_{I-1}), the others zero
      const int J = wg, I = wi;
      const bool live = I > J;
      float dh[8], dl[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) dh[i] = dl[i] = 0.0f;
      auto build = [&](int ks, uint32_t (&ah)[4], uint32_t (&al)[4]) {
        float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (live) {
          const int c0 = 8 * ks + t4;
          float m0 = 0.0f, m1 = 0.0f;
          for (int K = J + 1; K < I; ++K) {
            m0 += sT[K * kD + c0];
            m1 += sT[K * kD + c0 + 4];
          }
          const float f0 = ex2(m0), f1 = ex2(m1);
          const float* qa = sQ + (kSub * I + g) * kLdW + c0;
          x[0] = qa[0] * f0;
          x[1] = qa[8 * kLdW] * f0;
          x[2] = qa[4] * f1;
          x[3] = qa[8 * kLdW + 4] * f1;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) split(x[i], ah[i], al[i]);
      };
      auto issue = [&](int ks, uint32_t (&ah)[4], uint32_t (&al)[4]) {
        const uint32_t col =
            (ks & 3) * 32 + (ks >> 2) * (kC * 128) + kSub * J * 128;
        const uint64_t bh = sw128_desc(kth_a + col, 16, 1024);
        pin(dh);
        pin(dl);
        pin(ah);
        pin(al);
        wgmma_fence();
        wgmma_tf32_n16(dh, ah, bh);
        wgmma_tf32_n16(dl, ah, sw128_desc(ktl_a + col, 16, 1024));
        wgmma_tf32_n16(dl, al, bh);
        wgmma_commit();
      };
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
      build(0, ah0, al0);
#pragma unroll
      for (int ks = 0; ks < kD / 8; ks += 2) {
        issue(ks, ah0, al0);
        wgmma_wait_prev();
        build(ks + 1, ah1, al1);
        issue(ks + 1, ah1, al1);
        wgmma_wait_prev();
        if (ks + 2 < kD / 8) build(ks + 2, ah0, al0);
      }
      wgmma_wait_all();
      pin(dh);
      pin(dl);
      if (live) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = kSub * J + 8 * j + 2 * t4;
          const int ra = kSub * I + g;
          *reinterpret_cast<float2*>(sA + ra * kLdA + col) = make_float2(
              dh[4 * j] + dl[4 * j], dh[4 * j + 1] + dl[4 * j + 1]);
          *reinterpret_cast<float2*>(sA + (ra + 8) * kLdA + col) =
              make_float2(dh[4 * j + 2] + dl[4 * j + 2],
                          dh[4 * j + 3] + dl[4 * j + 3]);
        }
      }
    } else {
      // phase S (b), warpgroup 3 (mma.sync): the second half of sub-chunk
      // wi against its first half, both factors referenced at the half's
      // boundary (p); rows 8-15 of the tile repeat rows 0-7 and are dropped
      const int I = wi;
      const int arow = kSub * I + kHalf + g, brow = kSub * I + g;
      float dh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
      for (int ks = 0; ks < kD / 8; ++ks) {
        const int c0 = 8 * ks + 2 * t4;  // fragment k t -> c0, t + 4 -> c0 + 1
        const float2 qa =
            *reinterpret_cast<const float2*>(sP + arow * kLdW + c0);
        const float2 kt =
            *reinterpret_cast<const float2*>(sP + brow * kLdW + c0);
        uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
        split(qa.x, ah[0], al[0]);
        split(qa.y, ah[2], al[2]);
        ah[1] = ah[0];
        al[1] = al[0];
        ah[3] = ah[2];
        al[3] = al[2];
        split(kt.x, bh0, bl0);
        split(kt.y, bh1, bl1);
        mma(dh, ah, bh0, bh1);
        mma(dl, ah, bl0, bl1);
        mma(dm, al, bh0, bh1);
      }
      *reinterpret_cast<float2*>(sA + arow * kLdA + kSub * I + 2 * t4) =
          make_float2(dh[0] + (dl[0] + dm[0]), dh[1] + (dl[1] + dm[1]));
    }
    // phase-cost cut end: scores
    __syncthreads();

    if (!(wg & 1)) {
      // phase-cost cut begin: y-u
      // phase Y, warpgroups 0 and 2, half hf = wg / 2 each: q~ 2^(T_0 +
      // .. + T_{I-1}) S_in over channels 32 hf .. + 31 (3xTF32, wgmma m64
      // n64 k8 against the state's transpose, hi and lo), then A V over
      // keys 32 hf .. + 31 (A in three bf16 pieces, wgmma m64 n64 k16
      // against v); the hi.hi products and the corrections in separate
      // accumulators; each step's A fragment built while the last step
      // runs. Warpgroup 2 leaves its part in the incl buffer (free after
      // phase S); warpgroup 0 adds it and writes y
      const int hf = wg >> 1;
      const int I = wi;
      const int ra = kSub * I + g, rc = ra + 8;
      float yh[32], yl[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) yh[i] = yl[i] = 0.0f;
      {
        const int k0 = (kD / 16) * hf;  // first k8 step
        auto build_q = [&](int ks, uint32_t (&ah)[4], uint32_t (&al)[4]) {
          const int c0 = 8 * ks + t4;
          float b0 = 0.0f, b1 = 0.0f;
          for (int K = 0; K < I; ++K) {
            b0 += sT[K * kD + c0];
            b1 += sT[K * kD + c0 + 4];
          }
          const float f0 = ex2(b0), f1 = ex2(b1);
          const float* qa = sQ + ra * kLdW + c0;
          split(qa[0] * f0, ah[0], al[0]);
          split(qa[8 * kLdW] * f0, ah[1], al[1]);
          split(qa[4] * f1, ah[2], al[2]);
          split(qa[8 * kLdW + 4] * f1, ah[3], al[3]);
        };
        auto issue_q = [&](int ks, uint32_t (&ah)[4], uint32_t (&al)[4]) {
          const uint32_t col = (ks & 3) * 32 + (ks >> 2) * (kC * 128);
          const uint64_t bh = sw128_desc(sth_a + col, 16, 1024);
          pin(yh);
          pin(yl);
          pin(ah);
          pin(al);
          wgmma_fence();
          wgmma_tf32_n64(yh, ah, bh);
          wgmma_tf32_n64(yl, ah, sw128_desc(stl_a + col, 16, 1024));
          wgmma_tf32_n64(yl, al, bh);
          wgmma_commit();
        };
        uint32_t ah0[4], al0[4], ah1[4], al1[4];
        build_q(k0, ah0, al0);
#pragma unroll
        for (int ks = 0; ks < kD / 16; ks += 2) {
          issue_q(k0 + ks, ah0, al0);
          wgmma_wait_prev();
          build_q(k0 + ks + 1, ah1, al1);
          issue_q(k0 + ks + 1, ah1, al1);
          wgmma_wait_prev();
          if (ks + 2 < kD / 16) build_q(k0 + ks + 2, ah0, al0);
        }
      }
      // A V: register rg of k16 step kk is row ra (+ 8 when rg is odd),
      // keys 16 kk + 2 t4 (+ 8 when rg > 1), + 1; keys after the row are
      // masked (the scores there are not written)
      auto build_a = [&](int kk, uint32_t (&p0)[4], uint32_t (&p1)[4],
                         uint32_t (&p2)[4]) {
#pragma unroll
        for (int rg = 0; rg < 4; ++rg) {
          const int row = (rg & 1) ? rc : ra;
          const int j = 16 * kk + 2 * t4 + ((rg & 2) ? 8 : 0);
          const float2 x =
              *reinterpret_cast<const float2*>(sA + row * kLdA + j);
          split3(j > row ? 0.0f : x.x, j + 1 > row ? 0.0f : x.y, p0[rg],
                 p1[rg], p2[rg]);
        }
      };
      auto issue_a = [&](int kk, uint32_t (&p0)[4], uint32_t (&p1)[4],
                         uint32_t (&p2)[4]) {
        const uint64_t db = sw128_desc(v_a + kk * 2048, 1024, 1024);
        pin(yh);
        pin(yl);
        pin(p0);
        pin(p1);
        pin(p2);
        wgmma_fence();
        wgmma_rs_n64_tb(yh, p0, db);
        wgmma_rs_n64_tb(yl, p1, db);
        wgmma_rs_n64_tb(yl, p2, db);
        wgmma_commit();
      };
      const int kk0 = (kC / 32) * hf;  // first k16 step
      uint32_t p0[4], p1[4], p2[4], q0[4], q1[4], q2[4];
      build_a(kk0, p0, p1, p2);
      wgmma_wait_all();
      // the state's transpose is read: warpgroup 1 may overwrite it
      asm volatile("bar.arrive 2, 384;\n" ::: "memory");
      issue_a(kk0, p0, p1, p2);
      build_a(kk0 + 1, q0, q1, q2);
      issue_a(kk0 + 1, q0, q1, q2);
      wgmma_wait_all();
      pin(yh);
      pin(yl);
      if (hf) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(sI + ra * kLdW + col) = make_float2(
              yh[4 * j] + yl[4 * j], yh[4 * j + 1] + yl[4 * j + 1]);
          *reinterpret_cast<float2*>(sI + rc * kLdW + col) = make_float2(
              yh[4 * j + 2] + yl[4 * j + 2], yh[4 * j + 3] + yl[4 * j + 3]);
        }
        asm volatile("bar.arrive 3, 256;\n" ::: "memory");
      } else {
        asm volatile("bar.sync 3, 256;\n" ::: "memory");  // the other half
        const long long rowa = (long long)bb * t_len + t0 + ra;
        const long long rowc = rowa + 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t4;
          const float2 ea =
              *reinterpret_cast<const float2*>(sI + ra * kLdW + col);
          const float2 ec =
              *reinterpret_cast<const float2*>(sI + rc * kLdW + col);
          // phase-cost cut begin: y-store
          if (t0 + ra < t_len)
            *reinterpret_cast<float2*>(y + (rowa * h + head) * kD + col) =
                make_float2((yh[4 * j] + yl[4 * j]) + ea.x,
                            (yh[4 * j + 1] + yl[4 * j + 1]) + ea.y);
          if (t0 + rc < t_len)
            *reinterpret_cast<float2*>(y + (rowc * h + head) * kD + col) =
                make_float2((yh[4 * j + 2] + yl[4 * j + 2]) + ec.x,
                            (yh[4 * j + 3] + yl[4 * j + 3]) + ec.y);
          // phase-cost cut end: y-store
        }
      }
      // phase-cost cut end: y-u
    } else {
      // phase-cost cut begin: y-u
      // phase U, warpgroups 1 and 3, half hf = wg / 2 of the keys each:
      // (k~ 2^(T_{J+1} + .. + T_3))^T V over keys 32 hf .. + 31 (the keys'
      // side in three bf16 pieces, wgmma m64 n64 k16 against v) in fresh
      // accumulators. Warpgroup 3 leaves its part in the p buffer;
      // warpgroup 1 adds it to S 2^ltot in float32 and writes the state's
      // transpose, hi and lo, for the next chunk's q S. The state lives
      // there between chunks (hi + lo is it exactly): thread (wi, g, t4)
      // holds channels ca, cc and columns 8 j + 2 t4 (+ 1)
      const int hf = wg >> 1;
      const int ca = kSub * wi + g, cc = ca + 8;
      float suf_a[2], suf_c[2];  // 2^(T_{J+1} + .. + T_3), J = 2 hf, + 1
      float sa = 0.0f, sc = 0.0f;
#pragma unroll
      for (int J = kNSub - 1; J >= 0; --J) {
        if (J >> 1 == hf) {
          suf_a[J & 1] = ex2(sa);
          suf_c[J & 1] = ex2(sc);
        }
        sa += sT[J * kD + ca];
        sc += sT[J * kD + cc];
      }
      float d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = 0.0f;
      auto build_k = [&](int kk, uint32_t (&p0)[4], uint32_t (&p1)[4],
                         uint32_t (&p2)[4]) {
#pragma unroll
        for (int rg = 0; rg < 4; ++rg) {
          const int c = (rg & 1) ? cc : ca;
          const float f = (rg & 1) ? suf_c[kk & 1] : suf_a[kk & 1];
          const int j = 16 * kk + 2 * t4 + ((rg & 2) ? 8 : 0);
          const float k0 = *reinterpret_cast<const float*>(sKTh + swz(j, c)) +
                           *reinterpret_cast<const float*>(sKTl + swz(j, c));
          const float k1 =
              *reinterpret_cast<const float*>(sKTh + swz(j + 1, c)) +
              *reinterpret_cast<const float*>(sKTl + swz(j + 1, c));
          split3(k0 * f, k1 * f, p0[rg], p1[rg], p2[rg]);
        }
      };
      auto issue_k = [&](int kk, uint32_t (&p0)[4], uint32_t (&p1)[4],
                         uint32_t (&p2)[4]) {
        const uint64_t db = sw128_desc(v_a + kk * 2048, 1024, 1024);
        pin(d);
        pin(p0);
        pin(p1);
        pin(p2);
        wgmma_fence();
        wgmma_rs_n64_tb(d, p0, db);
        wgmma_rs_n64_tb(d, p1, db);
        wgmma_rs_n64_tb(d, p2, db);
        wgmma_commit();
      };
      const int kk0 = (kC / 32) * hf;
      uint32_t p0[4], p1[4], p2[4], q0[4], q1[4], q2[4];
      build_k(kk0, p0, p1, p2);
      issue_k(kk0, p0, p1, p2);
      build_k(kk0 + 1, q0, q1, q2);
      issue_k(kk0 + 1, q0, q1, q2);
      wgmma_wait_all();
      pin(d);
      if (hf) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(sP + ca * kLdW + col) =
              make_float2(d[4 * j], d[4 * j + 1]);
          *reinterpret_cast<float2*>(sP + cc * kLdW + col) =
              make_float2(d[4 * j + 2], d[4 * j + 3]);
        }
        asm volatile("bar.arrive 4, 256;\n" ::: "memory");
      } else {
        const float da = ex2(sa), dc = ex2(sc);
        float sreg[32];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = swz(8 * j + 2 * t4 + (e & 1), (e & 2) ? cc : ca);
            sreg[4 * j + e] = *reinterpret_cast<const float*>(sSTh + o) +
                              *reinterpret_cast<const float*>(sSTl + o);
          }
        asm volatile("bar.sync 4, 256;\n" ::: "memory");  // the other half
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t4;
          const float2 pa =
              *reinterpret_cast<const float2*>(sP + ca * kLdW + col);
          const float2 pc =
              *reinterpret_cast<const float2*>(sP + cc * kLdW + col);
          sreg[4 * j] = fmaf(sreg[4 * j], da, d[4 * j] + pa.x);
          sreg[4 * j + 1] = fmaf(sreg[4 * j + 1], da, d[4 * j + 1] + pa.y);
          sreg[4 * j + 2] = fmaf(sreg[4 * j + 2], dc, d[4 * j + 2] + pc.x);
          sreg[4 * j + 3] = fmaf(sreg[4 * j + 3], dc, d[4 * j + 3] + pc.y);
        }
        asm volatile("bar.sync 2, 384;\n" ::: "memory");  // q S has read it
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = (e & 2) ? cc : ca;
            const int col = 8 * j + 2 * t4 + (e & 1);
            uint32_t hi, lo;
            split(sreg[4 * j + e], hi, lo);
            *reinterpret_cast<uint32_t*>(sSTh + swz(col, c)) = hi;
            *reinterpret_cast<uint32_t*>(sSTl + swz(col, c)) = lo;
          }
        if (n + 1 == n_chunks) {
          float* fb = fin + (long long)bh * kD * kD;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + 2 * t4;
            *reinterpret_cast<float2*>(fb + ca * kD + col) =
                make_float2(sreg[4 * j], sreg[4 * j + 1]);
            *reinterpret_cast<float2*>(fb + cc * kD + col) =
                make_float2(sreg[4 * j + 2], sreg[4 * j + 3]);
          }
        }
      }
      // phase-cost cut end: y-u
    }
  }

}

Strides strides_of(const long long* st) {
  Strides s;
  for (int i = 0; i < 3; ++i) {
    s.r[i] = st[i];
    s.k[i] = st[3 + i];
    s.v[i] = st[6 + i];
    s.w[i] = st[9 + i];
  }
  return s;
}

}  // namespace

// st: element strides (batch, head, position) of r, then k, v and log_w;
// the last dim of each is unit-stride. y is (B, T, H, 64) contiguous, fin
// (B, H, 64, 64).
extern "C" int rwkv6_scan_f32_launch(const float* r, const float* k,
                                     const float* v, const float* log_w,
                                     const float* u, float* y, float* fin,
                                     const long long* st, int b, int h,
                                     int t_len, int dk, int dv,
                                     void* stream) {
  if (dk != kD || dv != kD) return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return 0;
  rwkv6_scan_seq<<<b * h, kSeqThreads, 0, (cudaStream_t)stream>>>(
      r, k, v, log_w, u, y, fin, strides_of(st), h, t_len);
  return (int)cudaGetLastError();
}

// the same, r, k, v in bf16: base pointers and strides 16-byte aligned
extern "C" int rwkv6_scan_bf16_launch(const void* r, const void* k,
                                      const void* v, const float* log_w,
                                      const float* u, float* y, float* fin,
                                      const long long* st, int b, int h,
                                      int t_len, int dk, int dv,
                                      void* stream) {
  if (dk != kD || dv != kD) return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return 0;
  cudaStream_t cs = (cudaStream_t)stream;
  if (t_len == 0)
    return (int)cudaMemsetAsync(fin, 0, sizeof(float) * b * h * kD * kD, cs);
  constexpr CUtensorMapDataType kBf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  Maps m;
  int code = make_map(&m.r, r, kBf, 2, kD, t_len, h, b, st, kD, kC);
  if (code == 0)
    code = make_map(&m.k, k, kBf, 2, kD, t_len, h, b, st + 3, kD, kC);
  if (code == 0)
    code = make_map(&m.v, v, kBf, 2, kD, t_len, h, b, st + 6, kD, kC);
  if (code == 0)
    code = make_map(&m.w, log_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kD,
                    t_len, h, b, st + 9, 32, kC);
  if (code != 0) return code;
  const cudaError_t e = cudaFuncSetAttribute(
      rwkv6_scan_chunked, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return (int)e;
  rwkv6_scan_chunked<<<b * h, kThreads, kSmem, cs>>>(m, u, y, fin, h, t_len);
  return (int)cudaGetLastError();
}

// bytes of dynamic shared memory the bf16 kernel launches with
extern "C" int rwkv6_scan_bf16_smem() { return kSmem; }
