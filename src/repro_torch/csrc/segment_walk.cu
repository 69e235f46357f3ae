// P2's budget walk over many sorted segments, one block a seed, no host
// sync: the consumer of density_sort_tiles_launch (budgeted_topk.cu) for
// more than 16,384 (client, ES) pairs a seed.
//
// Replaces no TPU kernel. The reference runs this walk as XLA's while_loop
// (src/repro/kernels/budgeted_topk/ops.py, greedy_walk :170, as
// budgeted_topk :299 calls it): one pick an iteration, each segment's first
// still-feasible candidate its head, the best head across segments by
// (density desc, flat index desc) the pick. The plain version is
// kernels/budgeted_topk/ref.py::greedy_walk over the same segments.
// In: density (S, nseg, P) f32 and flat (S, nseg, P) int32, each row sorted
// by (density desc, flat desc), pads (-inf, -1); costs (S, N) f32; budgets
// (S, M) f32. Out: assign (S, N) int32 (-1 = unselected), remaining (S, M).
//
// Why a head only moves forward. A candidate is feasible when its density
// is > 0, its client is free and its cost fits its ES's budget (+ 1e-12 in
// float32). Density is fixed, an assigned client stays assigned, and a
// budget only falls while costs are >= 0, so a candidate passed over stays
// infeasible and the first feasible candidate of a segment is never behind
// its head. A pick that raises its ES's budget (only a negative cost can)
// may revive a passed candidate: every head then goes back to its row's
// start, which is the reference's next step. The rows are sorted, so a
// head at a density <= 0 (not NaN) ends its segment. The work is
// O(pairs + picks x segments) against the plain walk's O(pairs x picks).
//
// Design: 1024 threads; each owns segments tid, tid + 1024, ... and caches
// its heads' position, density, flat and cost in shared memory, with the
// seed's budgets and an N-bit mask of taken clients (at N = 10^6, M = 64,
// tile 256: 3,907 segments, 188 KB). A pick re-tests each thread's heads
// against the mask and the budgets, moves the infeasible ones forward, and
// reduces (density, flat) over the block: a warp shuffle, then warp 0 over
// the 32 warp winners. Thread 0 applies the pick. Bound: the picks form a
// dependent chain of block-wide reductions (2 barriers a pick); the bytes,
// each pair's density and flat read once plus each client's cost, are far
// below it.
// Built with --fmad=false. No allocation; PyTorch's current stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-12f;               // the reference's float32 1e-12
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

// (d, f) is ahead of (bd, bf) in the pick order.
__device__ __forceinline__ bool ahead(float d, int f, float bd, int bf) {
  return d > bd || (d == bd && f > bf);
}

__global__ void __launch_bounds__(kThreads, 1)
segment_walk_kernel(const float* __restrict__ density,
                    const int* __restrict__ flat,
                    const float* __restrict__ costs,
                    const float* __restrict__ budgets,
                    int* __restrict__ assign, float* __restrict__ remaining,
                    int n, int m, int nseg, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* h_pos = reinterpret_cast<int*>(smem);
  float* h_d = reinterpret_cast<float*>(h_pos + nseg);
  int* h_f = reinterpret_cast<int*>(h_d + nseg);
  float* h_c = reinterpret_cast<float*>(h_f + nseg);
  float* rem = h_c + nseg;
  unsigned* taken = reinterpret_cast<unsigned*>(rem + m);
  __shared__ float w_d[kWarps];
  __shared__ int w_f[kWarps];
  __shared__ float s_d;
  __shared__ int s_f, s_restart;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long seed = blockIdx.x;
  const float* dens = density + seed * nseg * (long long)p;
  const int* fl = flat + seed * nseg * (long long)p;
  const float* cost = costs + seed * n;
  int* asg = assign + seed * n;

  for (int i = tid; i < n; i += kThreads) asg[i] = -1;
  for (int i = tid; i < (n + 31) / 32; i += kThreads) taken[i] = 0u;
  for (int i = tid; i < m; i += kThreads) rem[i] = budgets[seed * m + i];
  for (int sg = tid; sg < nseg; sg += kThreads) h_pos[sg] = -1;  // unloaded
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    float bd = neg_inf();
    int bf = -1;
    for (int sg = tid; sg < nseg; sg += kThreads) {
      int h = h_pos[sg];
      float d = h_d[sg], c = h_c[sg];
      int f = h_f[sg];
      bool load = h < 0;                     // first pick or a restart
      if (load) h = 0;
      while (h < p) {
        if (load) {
          const long long at = (long long)sg * p + h;
          d = dens[at];
          f = fl[at];
          if (!(d > 0.f)) {
            if (d != d) {                    // NaN: never feasible, skip
              ++h;
              continue;
            }
            h = p;                           // <= 0 from here on
            break;
          }
          c = cost[f / m];
        }
        const int cl = f / m;
        if (!((taken[cl >> 5] >> (cl & 31)) & 1u) &&
            c <= rem[f - cl * m] + kEps)
          break;                             // feasible head
        ++h;
        load = true;
      }
      h_pos[sg] = h;
      h_d[sg] = d;
      h_f[sg] = f;
      h_c[sg] = c;
      if (h < p && ahead(d, f, bd, bf)) {
        bd = d;
        bf = f;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(kFull, bd, o);
      const int of = __shfl_xor_sync(kFull, bf, o);
      if (ahead(od, of, bd, bf)) {
        bd = od;
        bf = of;
      }
    }
    if (lane == 0) {
      w_d[warp] = bd;
      w_f[warp] = bf;
    }
    __syncthreads();
    if (warp == 0) {
      bd = w_d[lane];
      bf = w_f[lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(kFull, bd, o);
        const int of = __shfl_xor_sync(kFull, bf, o);
        if (ahead(od, of, bd, bf)) {
          bd = od;
          bf = of;
        }
      }
      if (lane == 0) {
        s_d = bd;
        s_f = bf;
        s_restart = 0;
        if (bd > neg_inf()) {                // a feasible head: pick it
          const int cl = bf / m, es = bf - cl * m;
          const float old = rem[es];
          const float left = old + (-cost[cl]);
          rem[es] = left;
          taken[cl >> 5] |= 1u << (cl & 31);
          asg[cl] = es;
          s_restart = left > old;
        }
      }
    }
    __syncthreads();
    if (!(s_d > neg_inf())) break;           // no feasible candidate left
    // each thread reloads only its own heads, and reads s_* before the
    // next pick's first barrier, after which thread 0 writes them again
    if (s_restart)
      for (int sg = tid; sg < nseg; sg += kThreads) h_pos[sg] = -1;
  }
  for (int i = tid; i < m; i += kThreads) remaining[seed * m + i] = rem[i];
}

size_t smem_bytes(int n, int m, int nseg) {
  return (size_t)nseg * 16 + (size_t)m * 4 + (size_t)((n + 31) / 32) * 4;
}

}  // namespace

// Dynamic shared memory of one block (0 on a bad shape).
extern "C" long long segment_walk_smem(int n, int m, int nseg) {
  if (n < 0 || m <= 0 || nseg < 0) return 0;
  return (long long)smem_bytes(n, m, nseg);
}

extern "C" int segment_walk_launch(const float* density, const int* flat,
                                   const float* costs, const float* budgets,
                                   int* assign, float* remaining, int s,
                                   int n, int m, int nseg, int p,
                                   void* stream) {
  if (n < 0 || m <= 0 || nseg < 0 || p <= 0)
    return (int)cudaErrorInvalidValue;
  if (s == 0) return 0;
  const size_t smem = smem_bytes(n, m, nseg);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        segment_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  segment_walk_kernel<<<s, kThreads, smem, (cudaStream_t)stream>>>(
      density, flat, costs, budgets, assign, remaining, n, m, nseg, p);
  return (int)cudaGetLastError();
}
