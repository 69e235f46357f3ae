// P3's walk (the FLGreedy cost-benefit greedy under the Eq. 19 sqrt
// utility) for every seed in one launch, no host sync.
//
// Replaces no TPU kernel. The reference runs this walk as XLA, a
// lax.while_loop in src/repro/kernels/budgeted_topk/ops.py, flgreedy_walk
// (:244), over the segments that the TPU kernel density_sort_kernel
// (kernel.py:96) sorts; here B2's keys-only launch (budgeted_topk.cu)
// does that sort and this kernel walks its output. It is added because
// the walk is a chain of up to N picks, each a reduction over every
// candidate: as PyTorch ops that is ~20 launches and one host sync a pick.
// Each pick, as the reference's body:
//   util(x) = sqrt(max(x, 0) * float32(1 / M))   (XLA's reciprocal, R5)
//   gain    = util(total + value) - util(total)
//   rate    = gain / max(cost, 1e-12), over the candidates with cost > 0,
//             client unassigned, cost <= remaining[es] + 1e-12
//   pick    = the largest rate, ties toward the larger flat index
//             client * M + es (the reference's argmax over d[::-1]); a NaN
//             rate wins and ends the walk, as jnp.max lets it
//   ok      = rate > -inf and gain > 1e-15; then assign, remaining[es] +
//             (-cost), total + value; else the walk ends.
// Square roots and the division are IEEE round-to-nearest (__fsqrt_rn,
// __fdiv_rn), built with --fmad=false, so every rate is the plain
// version's bit for bit and so is every pick.
// In: keys (S, cap) u64 sorted, (order image of the density) << 32 |
// client << 14 | es, and counts (S,) int32, from B2's keys-only launch;
// values (S, N, M) f32, costs (S, N) f32, budgets (S, M) f32. Out: assign
// (S, N) int32 (-1 = unselected), remaining (S, M) f32.
//
// Bound on the H100. Bytes: values 4NM, costs 4N, keys 8 a candidate,
// budgets 4M, assign 4N, remaining 4M: ~230 KB at metropolis-1k's
// (2, 1000, 12), 0.07 us. Operations: each pick rescores every candidate,
// ~10 float operations each (two roots, a division), so picks x
// candidates x 10: ~0.35 us of the card's float32 rate at ~200 picks of
// ~3,400 candidates. What limits it is neither: each pick is a
// block-wide reduction whose result the next pick needs, two barriers and
// two shuffle trees a pick.
//
// Design: one block a seed; its candidates in registers (K a thread,
// value, cost, client, es), its budgets and an N-bit mask of assigned
// clients in shared memory. A pick: each thread rescores its candidates,
// a shuffle tree takes each warp's best (rate, flat), warp 0 takes the
// block's, and its lane 0 recomputes the winner's gain, tests it and
// applies the pick.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-12f;               // the reference's float32 1e-12
constexpr float kGainEps = 1e-15f;           // and its 1e-15

typedef unsigned long long u64;

__device__ __forceinline__ float util(float x, float rcp_m) {
  // jnp.maximum(x, 0) keeps a NaN; so does this
  return __fsqrt_rn((x < 0.f ? 0.f : x) * rcp_m);
}

// (r, f) beats (br, bf): a larger rate, NaN above every number, then the
// larger flat index.
__device__ __forceinline__ bool better(float r, int f, float br, int bf) {
  const bool rn = r != r, bn = br != br;
  if (rn != bn) return rn;
  if (!rn && r != br) return r > br;
  return f > bf;
}

__device__ __forceinline__ void warp_best(float& br, int& bf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float r = __shfl_xor_sync(kFull, br, off);
    const int f = __shfl_xor_sync(kFull, bf, off);
    if (better(r, f, br, bf)) {
      br = r;
      bf = f;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(1024)
flgreedy_walk_kernel(const u64* __restrict__ keys,
                     const int* __restrict__ counts,
                     const float* __restrict__ values,
                     const float* __restrict__ costs,
                     const float* __restrict__ budgets,
                     int* __restrict__ assign, float* __restrict__ remaining,
                     int n, int m, int cap, float rcp_m) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_rem = reinterpret_cast<float*>(smem);
  unsigned* s_taken = reinterpret_cast<unsigned*>(s_rem + m);
  __shared__ float s_r[32];
  __shared__ int s_f[32];
  __shared__ float s_total;
  __shared__ int s_live;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float kNegInf = __uint_as_float(0xff800000u);
  const long long seed = blockIdx.x;
  const int count = counts[seed];
  const u64* ks = keys + seed * cap;
  const float* vals = values + seed * (long long)n * m;
  const float* cst = costs + seed * n;
  int* asg = assign + seed * n;

  float v[K], c[K];
  int cl[K], es[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = k * blockDim.x + tid;
    cl[k] = -1;
    es[k] = 0;
    v[k] = 0.f;
    c[k] = 0.f;
    if (q < count) {
      const unsigned w = (unsigned)ks[q];
      cl[k] = (int)(w >> 14);
      es[k] = (int)(w & 0x3fffu);
      v[k] = vals[cl[k] * m + es[k]];
      c[k] = cst[cl[k]];
    }
  }
  for (int i = tid; i < n; i += blockDim.x) asg[i] = -1;
  for (int i = tid; i < m; i += blockDim.x) s_rem[i] = budgets[seed * m + i];
  for (int i = tid; i < (n + 31) / 32; i += blockDim.x) s_taken[i] = 0u;
  if (tid == 0) s_total = 0.f;
  __syncthreads();

  for (int pick = 0; pick < n; ++pick) {
    const float total = s_total;
    const float ut = util(total, rcp_m);
    float br = kNegInf;
    int bf = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (cl[k] < 0 || !(c[k] > 0.f)) continue;
      if ((s_taken[cl[k] >> 5] >> (cl[k] & 31)) & 1u) continue;
      if (!(c[k] <= s_rem[es[k]] + kEps)) continue;
      const float g = util(total + v[k], rcp_m) - ut;
      const float r = __fdiv_rn(g, c[k] < kEps ? kEps : c[k]);
      const int f = cl[k] * m + es[k];
      if (better(r, f, br, bf)) {
        br = r;
        bf = f;
      }
    }
    warp_best(br, bf);
    if (lane == 0) {
      s_r[warp] = br;
      s_f[warp] = bf;
    }
    __syncthreads();
    if (warp == 0) {
      br = lane < nwarps ? s_r[lane] : kNegInf;
      bf = lane < nwarps ? s_f[lane] : -1;
      warp_best(br, bf);
      if (lane == 0) {
        bool ok = br > kNegInf;              // false for NaN and for none
        if (ok) {
          const int i = bf / m, j = bf - i * m;
          const float pv = vals[bf], pc = cst[i];
          ok = util(total + pv, rcp_m) - ut > kGainEps;
          if (ok) {
            asg[i] = j;
            s_taken[i >> 5] |= 1u << (i & 31);
            s_rem[j] = s_rem[j] + (-pc);
            s_total = total + pv;
          }
        }
        s_live = ok;
      }
    }
    __syncthreads();
    if (!s_live) break;
  }
  for (int i = tid; i < m; i += blockDim.x)
    remaining[seed * m + i] = s_rem[i];
}

template <int K>
int launch(const u64* keys, const int* counts, const float* values,
           const float* costs, const float* budgets, int* assign,
           float* remaining, int s, int n, int m, int cap, float rcp_m,
           int threads, cudaStream_t stream) {
  const size_t smem = (size_t)m * sizeof(float) +
                      (size_t)((n + 31) / 32) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flgreedy_walk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flgreedy_walk_kernel<K><<<s, threads, smem, stream>>>(
      keys, counts, values, costs, budgets, assign, remaining, n, m, cap,
      rcp_m);
  return (int)cudaGetLastError();
}

}  // namespace

// cap: the keys' slots a seed (B2's key capacity); rcp_m: float32(1 / M).
extern "C" int flgreedy_walk_launch(const unsigned long long* keys,
                                    const int* counts, const float* values,
                                    const float* costs, const float* budgets,
                                    int* assign, float* remaining, int s,
                                    int n, int m, int cap, float rcp_m,
                                    void* stream) {
  const long long nm = (long long)n * m;
  if (n < 0 || m < 0 || nm > 16384 || cap < nm || m > 16384)
    return (int)cudaErrorInvalidValue;
  if (s == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (nm <= 1024) {
    int threads = 32;
    while (threads < nm) threads <<= 1;
    return launch<1>(keys, counts, values, costs, budgets, assign, remaining,
                     s, n, m, cap, rcp_m, threads, st);
  }
  const long long per = (nm + 1023) / 1024;
  if (per <= 2)
    return launch<2>(keys, counts, values, costs, budgets, assign, remaining,
                     s, n, m, cap, rcp_m, 1024, st);
  if (per <= 4)
    return launch<4>(keys, counts, values, costs, budgets, assign, remaining,
                     s, n, m, cap, rcp_m, 1024, st);
  if (per <= 8)
    return launch<8>(keys, counts, values, costs, budgets, assign, remaining,
                     s, n, m, cap, rcp_m, 1024, st);
  return launch<16>(keys, counts, values, costs, budgets, assign, remaining,
                    s, n, m, cap, rcp_m, 1024, st);
}
