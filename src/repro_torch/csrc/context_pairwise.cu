// Fused Eq. 4/5 pairwise context realization for the HFL device simulator.
//
// Replaces the TPU kernel src/repro/kernels/context_pairwise/kernel.py,
// context_pairwise_kernel (body _kernel): for every (seed, client, ES)
// pair, distance -> path-loss gain -> Eq. 4 Shannon rates under the
// downlink fading, the uplink fading and fading 1.0 -> Eq. 5 latency.
// Outputs dist, gain, mean rate and tau: four float32 (S, N, M) planes of
// one (4, S, N, M) buffer.
//
// Bound on the H100: memory in principle (per pair two fadings in, four
// floats out, ~0.2 us at the main path's 24,000 pairs), latency in fact:
// each thread runs one dependent chain of ~40 float operations, a
// logarithm, three log1p and six IEEE divisions, and there are few
// threads. So the design keeps that chain short and starts it early:
//
// * no barrier before the loads: a thread reads its ES coordinates
//   directly (__ldg; the table is a few hundred bytes and stays cached)
//   and issues all eight of its loads before any arithmetic, so a cold
//   call pays one round trip to device memory;
// * 32-bit index arithmetic where S * N * M < 2^31 (the wrapper picks
//   the instantiation), so the client row needs no 64-bit divide;
// * 10^x from the double exp10, whose rounding to float equals the
//   double pow's except within a few ulps of a float rounding midpoint,
//   where it calls pow (pow10_rn below);
// * 256-thread blocks: at the main path's 24,000 pairs that is 94
//   blocks of eight warps, and 38 of the 132 SMs idle, yet it measured
//   faster than 32, 64, 128, 512 or 1024 threads a block, cold and warm
//   (tools/kernel_turns.py --variants; PERF.md).
//
// Numerics: the primitive sequence is the plain version's (ref.py),
// operation for operation, which is the reference oracle as XLA executes
// it under jit: the squared distance fma(dy, dy, dx * dx), the path loss
// fma(log(d), 37.6 / ln 10, 128.1) with the constants folded, 10^(pl *
// -0.1) as (float)pow(10.0, (double)x), the rate B * (log1p(snr) * (1 /
// ln 2)), IEEE division and square root. Built with --fmad=false so nvcc
// contracts nothing on its own: the fused multiply-adds are the explicit
// __fmaf_rn calls, exactly where the reference has them. Context binning
// floors rate / rate_hi and Eq. 6 thresholds tau, so a reordering would
// change decisions.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// CUDA's double exp10 is within 1 ulp and its double pow within 2, so
// the two differ by at most 3 ulps of the result; where a float rounding
// midpoint is farther than that from exp10's value, both round to the
// same float. The margin is 64 ulps, twenty times what the bounds need:
// a thread takes pow once in 2^22 draws, and a bound off by a few ulps
// still leaves the result exact.
constexpr long long kMidpointMargin = 64;

struct Consts {
  float tx_w, noise, bits, workload, pl_slope, pl_icpt, neg_tenth, rcp_ln2;
};

// (float)pow(10.0, (double)x), bit for bit. The 29 bits of a double's
// significand below float's 24 say where it lies between two floats of
// its binade: 2^28 is the midpoint. Below 2^-126 a float is subnormal and
// rounds at another bit, so that range takes pow too.
__device__ __forceinline__ float pow10_rn(float x) {
  const double y = exp10((double)x);
  const long long low = __double_as_longlong(y) & ((1LL << 29) - 1);
  const long long off = low - (1LL << 28);
  if (y >= 0x1p-126 && (off > kMidpointMargin || off < -kMidpointMargin))
    return __double2float_rn(y);
  return (float)pow(10.0, (double)x);
}

__device__ __forceinline__ float shannon(float bw, float g, float tx_w,
                                         float noise, float rcp_ln2) {
  float snr = (tx_w * g) / (noise * bw);
  return bw * (log1pf(snr) * rcp_ln2);
}

template <typename Index>
__global__ void __launch_bounds__(kThreads) context_pairwise_kernel(
    const float* __restrict__ pos, const float* __restrict__ es,
    const float* __restrict__ bw, const float* __restrict__ comp,
    const float* __restrict__ fdt, const float* __restrict__ fut,
    float* __restrict__ out, Index total, Index m, Consts c) {
  const Index idx = (Index)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const Index row = idx / m;  // seed * N + client
  const Index j = idx - row * m;
  const float px = __ldg(pos + 2 * row), py = __ldg(pos + 2 * row + 1);
  const float ex = __ldg(es + 2 * j), ey = __ldg(es + 2 * j + 1);
  const float b = __ldg(bw + row), cp = __ldg(comp + row);
  const float f_dt = __ldg(fdt + idx), f_ut = __ldg(fut + idx);
  const float dx = px - ex;
  const float dy = py - ey;
  const float d = sqrtf(__fmaf_rn(dy, dy, dx * dx));
  const float pl = __fmaf_rn(logf(fmaxf(d, 0.01f)), c.pl_slope, c.pl_icpt);
  const float g0 = pow10_rn(pl * c.neg_tenth);
  const float r_dt = shannon(b, f_dt * g0, c.tx_w, c.noise, c.rcp_ln2);
  const float r_ut = shannon(b, f_ut * g0, c.tx_w, c.noise, c.rcp_ln2);
  float t = c.bits / fmaxf(r_dt, 1e-9f) + c.workload / fmaxf(cp, 1e-9f);
  t = t + c.bits / fmaxf(r_ut, 1e-9f);
  float* o = out + idx;  // plane p of the output at o + p * total
  o[0] = d;
  o += total;
  o[0] = g0;
  o += total;
  o[0] = shannon(b, g0, c.tx_w, c.noise, c.rcp_ln2);
  o += total;
  o[0] = t;
}

template <typename Index>
int launch(const float* pos, const float* es, const float* bw,
           const float* comp, const float* fdt, const float* fut,
           float* out, long long total, int m, const Consts& c,
           cudaStream_t stream) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  context_pairwise_kernel<Index><<<(unsigned)blocks, kThreads, 0, stream>>>(
      pos, es, bw, comp, fdt, fut, out, (Index)total, (Index)m, c);
  return (int)cudaGetLastError();
}

}  // namespace

// consts: tx_w, noise, bits, workload, pl_slope, pl_icpt, neg_tenth,
// rcp_ln2 (host memory, read before the call returns). wide: 64-bit
// indices, for S * N * M >= 2^31.
extern "C" int context_pairwise_launch(
    const float* pos, const float* es, const float* bw, const float* comp,
    const float* fdt, const float* fut, float* out, int s, int n, int m,
    const float* consts, int wide, void* stream) {
  const long long total = (long long)s * n * m;
  if (total == 0) return 0;
  const Consts c = {consts[0], consts[1], consts[2], consts[3],
                    consts[4], consts[5], consts[6], consts[7]};
  cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch<unsigned long long>(pos, es, bw, comp, fdt, fut, out,
                                      total, m, c, st);
  return launch<unsigned>(pos, es, bw, comp, fdt, fut, out, total, m, c,
                          st);
}
