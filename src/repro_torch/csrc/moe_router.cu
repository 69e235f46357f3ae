// MoE router: softmax over the experts, top-k gates, renormalised.
//
// Replaces the TPU kernel src/repro/kernels/moe_router/kernel.py,
// moe_router_kernel (body _kernel), and computes what the model's
// routing (src/repro/models/moe.py, route) computes: for token row t of
// logits (T, E), float32 or bfloat16,
//   p = softmax(float32(logits[t]))            (exp(x - max) / sum)
//   the k experts of largest p, ordered by (p desc, index asc), as
//   lax.top_k orders them;
//   gates = p[chosen] / sum(p[chosen]),  idx = chosen (int32).
// Each chosen expert is marked taken for the later rounds. The TPU
// kernel instead zeroes its probability, so in a row with fewer than k
// nonzero probabilities it can pick one expert twice; route's
// lax.top_k, and this kernel, pick the next index.
//
// Bound on the H100: at the serve path's prefill shape (T, E, k) =
// (4096, 8, 2) the function reads 131 KB of float32 logits and writes
// 65.5 KB of gates and indices, 0.059 us at 3.35 TB/s; its ~20 operations
// per logit are fewer still. So a launch (a few us) bounds it, at decode
// (8 tokens) even more. The design is the simplest correct one: one warp
// per token row, lanes striding over the E experts (E <= 384, so a lane
// holds at most 12 values in registers), the row's max and sum by warp
// shuffles, then k rounds of a warp argmax over the untaken experts. A
// lane keeps its experts in index order, so "strictly greater" keeps the
// lower index on a tie within the lane and the shuffle compares indices
// on a tie across lanes. expf (not __expf) and IEEE division, as the
// plain version uses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 rows a block
constexpr int kMaxTopK = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
    moe_router_kernel(const T* __restrict__ logits,
                      float* __restrict__ gates, int* __restrict__ idx,
                      int t, int e, int k) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) /
                        kWarp;
  if (row >= t) return;  // the whole warp leaves together
  const T* x = logits + row * e;

  float p[kPer];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + kWarp * j;
    p[j] = c < e ? to_f32(x[c]) : -INFINITY;
    m = fmaxf(m, p[j]);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + kWarp * j;
    p[j] = c < e ? expf(p[j] - m) : 0.0f;
    s += p[j];
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
  for (int j = 0; j < kPer; ++j) p[j] = p[j] / s;

  unsigned taken = 0u;  // bit j: expert lane + 32 j already chosen
  float total = 0.0f;
  float my_gate = 0.0f;  // lane r keeps round r's pick
  int my_idx = 0;
  for (int r = 0; r < k; ++r) {
    float bv = -1.0f;  // below every probability
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = lane + kWarp * j;
      if (c < e && !((taken >> j) & 1u) && p[j] > bv) {
        bv = p[j];
        bi = c;
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if ((bi & (kWarp - 1)) == lane) taken |= 1u << (bi / kWarp);
    total += bv;
    if (lane == r) {
      my_gate = bv;
      my_idx = bi;
    }
  }
  if (lane < k) {
    gates[row * k + lane] = my_gate / total;
    idx[row * k + lane] = my_idx;
  }
}

template <typename T>
int launch(const T* logits, float* gates, int* idx, int t, int e, int k,
           void* stream) {
  if (t == 0) return 0;
  if (e < 1 || e > 12 * kWarp || k < 1 || k > kMaxTopK || k > e)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      ((long long)t * kWarp + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)blocks);
  cudaStream_t st = (cudaStream_t)stream;
  if (e <= kWarp)
    moe_router_kernel<T, 1><<<grid, kThreads, 0, st>>>(logits, gates, idx,
                                                       t, e, k);
  else if (e <= 2 * kWarp)
    moe_router_kernel<T, 2><<<grid, kThreads, 0, st>>>(logits, gates, idx,
                                                       t, e, k);
  else if (e <= 4 * kWarp)
    moe_router_kernel<T, 4><<<grid, kThreads, 0, st>>>(logits, gates, idx,
                                                       t, e, k);
  else
    moe_router_kernel<T, 12><<<grid, kThreads, 0, st>>>(logits, gates, idx,
                                                        t, e, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int moe_router_f32_launch(const float* logits, float* gates,
                                     int* idx, int t, int e, int k,
                                     void* stream) {
  return launch(logits, gates, idx, t, e, k, stream);
}

extern "C" int moe_router_bf16_launch(const __nv_bfloat16* logits,
                                      float* gates, int* idx, int t, int e,
                                      int k, void* stream) {
  return launch(logits, gates, idx, t, e, k, stream);
}
