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
// the metropolis-1k slice, whose slot capacity is each round's largest cohort)
// and does two floating-point operations per delta it reads, far below
// the card's ratio of operations to bytes. The design streams the deltas
// once with no reuse to arrange: a grid over (D tile, row), threads on
// consecutive d so each slot's row of deltas is read as coalesced
// 128-byte lines, the row's weights in shared memory, one accumulator in
// a register. All rows go in one launch (the TPU wrapper makes one
// pallas_call per row). Slot s is accumulated in order s = 0, 1, ..., as
// the plain version does, so the two agree bitwise under --fmad=false; a
// padded slot has weight 0 and adds exactly 0 * delta = 0 for any finite
// delta.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void masked_aggregate_kernel(const float* __restrict__ param,
                                        const float* __restrict__ deltas,
                                        const float* __restrict__ weights,
                                        float* __restrict__ out, int slots,
                                        int d) {
  extern __shared__ float w_s[];
  const int r = blockIdx.y;
  for (int s = threadIdx.x; s < slots; s += blockDim.x)
    w_s[s] = weights[(long long)r * slots + s];
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float denom = 0.0f;
  float acc = 0.0f;
  const float* row = deltas + (long long)r * slots * d + col;
  for (int s = 0; s < slots; ++s) {
    denom = denom + w_s[s];
    acc = acc + w_s[s] * row[(long long)s * d];
  }
  const long long o = (long long)r * d + col;
  out[o] = param[o] + acc / fmaxf(denom, 1.0f);
}

}  // namespace

extern "C" int masked_aggregate_launch(const float* param,
                                       const float* deltas,
                                       const float* weights, float* out,
                                       int rows, int slots, int d,
                                       void* stream) {
  if (rows == 0 || d == 0) return 0;
  dim3 grid((d + kThreads - 1) / kThreads, rows);
  masked_aggregate_kernel<<<grid, kThreads, slots * sizeof(float),
                            (cudaStream_t)stream>>>(param, deltas, weights,
                                                    out, slots, d);
  return (int)cudaGetLastError();
}
