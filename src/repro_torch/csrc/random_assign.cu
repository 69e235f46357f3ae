// Random's scan: a feasible random assignment for every seed in one
// launch, no host sync.
//
// Replaces no TPU kernel. The reference runs this step as XLA, a
// lax.scan in src/repro/policies/solvers.py, random_assign (:148): clients
// in a random order, each to the Gumbel argmax among the ESs it is
// eligible for whose budget still covers its cost (cost <= remaining, no
// slack; the first such ES on a tie, as jnp.argmax), that ES's budget
// reduced by the cost (remaining + (-cost)). It is added because the scan
// is N dependent steps: as PyTorch ops it is ~6 launches a step, and the
// port keeps selections off the host (no sync a round).
// In: order (S, N) int32 (a permutation of the clients), gumbel (S, N, M)
// f32, costs (S, N) f32, budgets (S, M) f32, eligible (S, N, M) bool. The
// draws are made outside (repro_torch.random) and are inputs here. Out:
// assign (S, N) int32 (-1 = unselected), remaining (S, M) f32.
//
// Bound on the H100. Bytes at metropolis-1k's (2, 1000, 12): gumbel 96,000,
// eligible 24,000, order 8,000, costs 8,000, budgets 96, assign 8,000,
// remaining 96: ~144 KB, 0.043 us at 3.35 TB/s. That is not what limits
// it: step k's budgets are step k+1's input, so the kernel is a chain of
// N steps, each a compare, two warp reductions and one add.
//
// Design: one warp a seed. Lane l owns the ESs l, l + 32, .. (R of them,
// R = ceil(M / 32), at most 8) and keeps their budgets in registers, so a
// step touches no shared memory. The loads do not depend on the chain:
// 32 steps' client indices and costs are read at once (a lane each) and
// each batch of 8 steps' eligibility and Gumbel rows are loaded before
// the chain reaches them. A step: each lane takes its best feasible ES
// (the larger Gumbel, the lower ES on a tie), then the warp takes the
// largest Gumbel (__reduce_max_sync on an order-preserving image of the
// float, -0.0 counted as +0.0) and the lowest ES holding it
// (__reduce_min_sync); the lane that owns that ES writes assign and
// lowers its budget. No thread reads another's budget, so no barrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 8;                    // steps whose rows load at once
constexpr unsigned kNoEs = 0xffffffffu;

// An unsigned image of a float that orders as the floats do; 0 is below
// every float's image, so it stands for "no feasible ES".
__device__ __forceinline__ unsigned order_key(float g) {
  const unsigned u = __float_as_uint(g + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int R>
__global__ void __launch_bounds__(32)
random_assign_kernel(const int* __restrict__ order,
                     const float* __restrict__ gumbel,
                     const float* __restrict__ costs,
                     const float* __restrict__ budgets,
                     const unsigned char* __restrict__ eligible,
                     int* __restrict__ assign, float* __restrict__ remaining,
                     int n, int m) {
  const int lane = threadIdx.x;
  const long long seed = blockIdx.x;
  const int* ord = order + seed * n;
  const float* cst = costs + seed * n;
  const float* gum = gumbel + seed * (long long)n * m;
  const unsigned char* elg = eligible + seed * (long long)n * m;
  int* asg = assign + seed * n;

  float rem[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = lane + 32 * r;
    rem[r] = j < m ? budgets[seed * m + j] : 0.f;
  }
  for (int i = lane; i < n; i += 32) asg[i] = -1;
  __syncwarp();

  for (int base = 0; base < n; base += 32) {
    const int steps = min(32, n - base);
    const int my_i = lane < steps ? ord[base + lane] : 0;
    const float my_c = lane < steps ? cst[my_i] : 0.f;
    for (int sub = 0; sub < steps; sub += kBatch) {
      float g[kBatch][R];
      bool e[kBatch][R];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = __shfl_sync(kFull, my_i, (sub + u) & 31);
        const bool live = sub + u < steps;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = lane + 32 * r;
          const bool in = live && j < m;
          const long long at = (long long)i * m + j;
          g[u][r] = in ? gum[at] : 0.f;
          e[u][r] = in && elg[at];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (sub + u >= steps) break;         // warp-uniform
        const int i = __shfl_sync(kFull, my_i, sub + u);
        const float c = __shfl_sync(kFull, my_c, sub + u);
        unsigned best = 0u, best_j = kNoEs;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned k = (e[u][r] && c <= rem[r]) ? order_key(g[u][r])
                                                      : 0u;
          if (k > best) {                    // r ascends: first max kept
            best = k;
            best_j = (unsigned)(lane + 32 * r);
          }
        }
        const unsigned top = __reduce_max_sync(kFull, best);
        if (top == 0u) continue;             // no feasible ES: unselected
        const unsigned j = __reduce_min_sync(kFull,
                                             best == top ? best_j : kNoEs);
        if ((int)(j & 31u) == lane) {
          const int r = (int)(j >> 5);
#pragma unroll
          for (int q = 0; q < R; ++q)
            if (q == r) rem[q] = rem[q] + (-c);
          asg[i] = (int)j;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = lane + 32 * r;
    if (j < m) remaining[seed * m + j] = rem[r];
  }
}

}  // namespace

extern "C" int random_assign_launch(const int* order, const float* gumbel,
                                    const float* costs, const float* budgets,
                                    const unsigned char* eligible,
                                    int* assign, float* remaining, int s,
                                    int n, int m, void* stream) {
  if (n < 0 || m < 0 || m > 256) return (int)cudaErrorInvalidValue;
  if (s == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 32)
    random_assign_kernel<1><<<s, 32, 0, st>>>(order, gumbel, costs, budgets,
                                              eligible, assign, remaining, n,
                                              m);
  else if (m <= 64)
    random_assign_kernel<2><<<s, 32, 0, st>>>(order, gumbel, costs, budgets,
                                              eligible, assign, remaining, n,
                                              m);
  else if (m <= 128)
    random_assign_kernel<4><<<s, 32, 0, st>>>(order, gumbel, costs, budgets,
                                              eligible, assign, remaining, n,
                                              m);
  else
    random_assign_kernel<8><<<s, 32, 0, st>>>(order, gumbel, costs, budgets,
                                              eligible, assign, remaining, n,
                                              m);
  return (int)cudaGetLastError();
}
