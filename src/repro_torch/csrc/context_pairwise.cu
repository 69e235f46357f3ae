// Fused Eq. 4/5 pairwise context realization for the HFL device simulator.
//
// Replaces the TPU kernel src/repro/kernels/context_pairwise/kernel.py,
// context_pairwise_kernel (body _kernel): for every (seed, client, ES)
// pair, distance -> path-loss gain -> Eq. 4 Shannon rates under the
// downlink fading, the uplink fading and fading 1.0 -> Eq. 5 latency.
// Outputs dist, gain, mean rate and tau, four float32 (S, N, M) tensors.
//
// Bound on the H100: memory. Per pair it reads two fadings (8 B) and
// writes four floats (16 B); the client row (position, bandwidth,
// compute) is shared by the M pairs of a client and the ES table by
// every pair. About 40 float operations a pair is far below the card's
// ratio of operations to bytes, so the design only has to stream the
// fadings and outputs once: one thread per pair, consecutive threads on
// consecutive (client, ES) pairs for coalesced loads and stores, every
// intermediate in registers, the (M, 2) ES table staged in shared memory
// once per block, and all seeds in one launch (the TPU version gets its
// seed axis from vmap over pallas_call).
//
// Numerics: the primitive sequence is the plain version's (ref.py),
// operation for operation, which is the reference oracle as XLA executes
// it under jit: the squared distance fma(dy, dy, dx * dx), the path loss
// fma(log(d), 37.6 / ln 10, 128.1) with the constants folded, 10^(pl *
// -0.1) rounded from double, the rate B * (log1p(snr) * (1 / ln 2)), IEEE
// division and square root. Built with --fmad=false so nvcc contracts
// nothing on its own: the fused multiply-adds are the explicit
// __fmaf_rn calls, exactly where the reference has them. Context binning
// floors rate / rate_hi and Eq. 6 thresholds tau, so a reordering would
// change decisions.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float shannon(float bw, float g, float tx_w,
                                         float noise, float rcp_ln2) {
  float snr = (tx_w * g) / (noise * bw);
  return bw * (log1pf(snr) * rcp_ln2);
}

__global__ void context_pairwise_kernel(
    const float* __restrict__ pos, const float* __restrict__ es,
    const float* __restrict__ bw, const float* __restrict__ comp,
    const float* __restrict__ fdt, const float* __restrict__ fut,
    float* __restrict__ dist, float* __restrict__ gain,
    float* __restrict__ rate, float* __restrict__ tau, long long total,
    int m, float tx_w, float noise, float bits, float workload,
    float pl_slope, float pl_icpt, float neg_tenth, float rcp_ln2) {
  extern __shared__ float es_s[];
  for (int i = threadIdx.x; i < 2 * m; i += blockDim.x) es_s[i] = es[i];
  __syncthreads();
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int j = (int)(idx % m);
  long long row = idx / m;  // seed * N + client
  float dx = pos[2 * row] - es_s[2 * j];
  float dy = pos[2 * row + 1] - es_s[2 * j + 1];
  float d = sqrtf(__fmaf_rn(dy, dy, dx * dx));
  float pl = __fmaf_rn(logf(fmaxf(d, 0.01f)), pl_slope, pl_icpt);
  float g0 = (float)pow(10.0, (double)(pl * neg_tenth));
  float b = bw[row];
  float r_dt = shannon(b, fdt[idx] * g0, tx_w, noise, rcp_ln2);
  float r_ut = shannon(b, fut[idx] * g0, tx_w, noise, rcp_ln2);
  float t = bits / fmaxf(r_dt, 1e-9f) + workload / fmaxf(comp[row], 1e-9f);
  t = t + bits / fmaxf(r_ut, 1e-9f);
  dist[idx] = d;
  gain[idx] = g0;
  rate[idx] = shannon(b, g0, tx_w, noise, rcp_ln2);
  tau[idx] = t;
}

}  // namespace

extern "C" int context_pairwise_launch(
    const float* pos, const float* es, const float* bw, const float* comp,
    const float* fdt, const float* fut, float* dist, float* gain,
    float* rate, float* tau, int s, int n, int m, float tx_w, float noise,
    float bits, float workload, float pl_slope, float pl_icpt,
    float neg_tenth, float rcp_ln2, void* stream) {
  long long total = (long long)s * n * m;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  context_pairwise_kernel<<<(unsigned)blocks, threads,
                            2 * m * sizeof(float), (cudaStream_t)stream>>>(
      pos, es, bw, comp, fdt, fut, dist, gain, rate, tau, total, m, tx_w,
      noise, bits, workload, pl_slope, pl_icpt, neg_tenth, rcp_ln2);
  return (int)cudaGetLastError();
}
