// Deadline-masked weighted aggregation of client updates (HFL Eq. 3/6).
//
// Replaces the TPU kernel src/repro/kernels/masked_aggregate/kernel.py,
// masked_aggregate_kernel (body _kernel): for every row r (a (seed, ES)
// pair) and parameter d,
//   out[r, d] = param[r, d] + (sum_s w[r, s] * delta[r, s, d])
//                             / max(sum_s w[r, s], 1)
// with float32 accumulation, the division after the weighted sum.
//
// Bound on the H100: memory. The kernel must read every delta once
// (rows x slots x D x 4 bytes: 24 x 24..27 x 7850 x 4, 18-20 MB a round on
// the metropolis-1k slice, whose slot capacity is each round's largest
// cohort) and does two floating-point operations per delta it reads, far
// below the card's ratio of operations to bytes. To read at the memory's
// rate the card needs some 2-2.5 MB of loads in flight (3.35 TB/s times
// ~0.7 us of latency); a thread that adds each slot before it loads the
// next has one load in flight, and ~190 k threads x 4 B is too little. So:
//
// * a thread owns V adjacent columns (V = 2, float2 loads, where D is even
//   and the row bases 8-byte aligned, which the launcher checks; else 1);
// * it issues the loads of a group of kGroup = 8 slots into registers
//   before it adds any of them, then adds them in slot order and moves to
//   the next group (the last group predicated for slots % 8), which puts
//   8 x V loads of each thread in flight; the first group's loads, and
//   the thread's parameters, go out before the block waits for its
//   weights;
// * the row's weights sit in shared memory, and one thread sums them into
//   the denominator for the whole block.
//
// Deltas are read through the read-only path (ld.global.nc), not as
// streaming loads: those mark the lines evict-first, which is faster with
// the L2 flushed but much slower with the deltas in the L2, as on the
// main path, where training has just written them.
//
// A grid over (column tile, row), threads on consecutive columns so each
// slot's row of deltas is read as coalesced lines; all rows in one launch
// (the TPU wrapper makes one pallas_call per row). Slot s is accumulated
// in order s = 0, 1, ..., as the plain version does, so the two agree
// bitwise under --fmad=false; a padded slot has weight 0 and adds exactly
// 0 * delta = 0 for any finite delta.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // slots whose loads are in flight together

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static T madd(T acc, float w, T x) { return acc + w * x; }
  __device__ static T fin(T p, T acc, float den) { return p + acc / den; }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.0f, 0.0f); }
  __device__ static T madd(T acc, float w, T x) {
    return make_float2(acc.x + w * x.x, acc.y + w * x.y);
  }
  __device__ static T fin(T p, T acc, float den) {
    return make_float2(p.x + acc.x / den, p.y + acc.y / den);
  }
};

template <int V>
__global__ void __launch_bounds__(kThreads)
    masked_aggregate_kernel(const float* __restrict__ param,
                            const float* __restrict__ deltas,
                            const float* __restrict__ weights,
                            float* __restrict__ out, int slots, int d) {
  using VT = typename Vec<V>::T;
  extern __shared__ float w_s[];  // the slots' weights, then the denominator
  const int r = blockIdx.y;
  const int cols = d / V;  // vectors a row
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < cols;
  const VT* src =
      reinterpret_cast<const VT*>(deltas + (long long)r * slots * d) + c;
  const long long o = (long long)r * cols + c;
  VT pv = Vec<V>::zero();
  VT buf[kGroup];
  if (live) {
    pv = __ldg(reinterpret_cast<const VT*>(param) + o);
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (j < slots) buf[j] = __ldg(src + (long long)j * cols);
  }
  for (int s = threadIdx.x; s < slots; s += blockDim.x)
    w_s[s] = weights[(long long)r * slots + s];
  __syncthreads();
  if (threadIdx.x == 0) {
    float denom = 0.0f;
    for (int s = 0; s < slots; ++s) denom = denom + w_s[s];
    w_s[slots] = fmaxf(denom, 1.0f);
  }
  VT acc = Vec<V>::zero();
  if (live) {
    for (int s0 = 0; s0 < slots; s0 += kGroup) {
      if (s0 > 0) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (s0 + j < slots)
            buf[j] = __ldg(src + (long long)(s0 + j) * cols);
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (s0 + j < slots) acc = Vec<V>::madd(acc, w_s[s0 + j], buf[j]);
    }
  }
  __syncthreads();  // the denominator is written
  if (live) reinterpret_cast<VT*>(out)[o] = Vec<V>::fin(pv, acc, w_s[slots]);
}

}  // namespace

extern "C" int masked_aggregate_launch(const float* param,
                                       const float* deltas,
                                       const float* weights, float* out,
                                       int rows, int slots, int d,
                                       void* stream) {
  if (rows == 0 || d == 0) return 0;
  const size_t smem = (slots + 1) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 8 == 0;
  };
  // two adjacent columns a thread where every row of every tensor starts
  // on an 8-byte boundary
  if (d % 2 == 0 && aligned(param) && aligned(deltas) && aligned(out)) {
    dim3 grid((d / 2 + kThreads - 1) / kThreads, rows);
    masked_aggregate_kernel<2><<<grid, kThreads, smem, st>>>(
        param, deltas, weights, out, slots, d);
  } else {
    dim3 grid((d + kThreads - 1) / kThreads, rows);
    masked_aggregate_kernel<1><<<grid, kThreads, smem, st>>>(
        param, deltas, weights, out, slots, d);
  }
  return (int)cudaGetLastError();
}
