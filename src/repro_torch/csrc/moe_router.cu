// MoE router: softmax over the experts, top-k gates, renormalised.
//
// Replaces the TPU kernel src/repro/kernels/moe_router/kernel.py,
// moe_router_kernel (body _kernel), and computes what the model's
// routing (src/repro/models/moe.py, route) computes: for token row t of
// logits (T, E), float32 or bfloat16,
//   p = softmax(float32(logits[t]))            (exp(x - max) / sum)
//   the k experts in lax.top_k's order: p descending, NaN above every
//   number, the lower expert index first on a tie (between NaNs too);
//   gates = p[chosen] / sum(p[chosen]),  idx = chosen (int32).
// A row whose sum is not finite (a NaN or +inf logit, or every logit
// -inf) has every p NaN, so it gives indices 0..k-1 and NaN gates, as
// lax.top_k does. Each chosen expert is marked taken for the later
// rounds. The TPU kernel instead zeroes its probability, so in a row
// with fewer than k nonzero probabilities it can pick one expert twice;
// route's lax.top_k, and this kernel, pick the next index.
//
// What bounds it on the H100 is not bytes. At the serve path's prefill
// shape (T, E, k) = (4096, 8, 2) the function reads 131 KB of float32
// logits and writes 65.5 KB of gates and indices, 0.059 us at 3.35
// TB/s, and a decode step's (8, 8, 2) a thousandth of that; its ~20
// operations a logit are fewer still. A call costs the launch floor (an
// empty kernel, ~0.9 us), one round trip of loads from device memory,
// and the chain of arithmetic after it. So the design adds no step to
// that chain:
//
// * E <= 32 (mixtral's 8): one thread per token row. The thread loads
//   its whole row into registers before any arithmetic, in 16-byte
//   vectors where the row's address and E allow (E = 8 is two float4 in
//   float32, one 16-byte load in bfloat16), so a warp reads 32
//   neighbouring rows as one contiguous run. The max, the sum and the k
//   rounds of picks then run over the registers in index order, with no
//   shuffle, no shared memory and no barrier; a warp a row would leave
//   24 of 32 lanes idle at E = 8 and make the max, the sum and each pick
//   a 5-step shuffle chain. Blocks of 64 threads: 32, 64 and 128
//   measured alike, 256 slower at the prefill's 4096 rows
//   (tools/kernel_turns.py --variants moe_router; PERF.md);
// * E > 32 (up to kimi-k2's 384): one warp per row, lanes striding over
//   the experts (a lane holds at most 12 values), the max and sum by
//   warp shuffles, then k rounds of a warp argmax over the untaken
//   experts. No served model reaches it yet.
//
// NaN ranks above every number, yet no comparison needs to test for
// it: in a row either every probability is NaN or none is. The sum is
// NaN exactly when a logit is NaN or +inf or every logit is -inf (then
// some exp(x - max) is NaN); otherwise every exp(x - max) lies in
// [0, 1], the largest is 1, and the sum is finite and at least 1. So
// each path tests the sum once: a NaN row takes experts 0..k-1 in index
// order with NaN gates; any other row picks by "strictly greater" in
// index order, which keeps the lower index on a tie. expf (not __expf)
// and IEEE division, as the plain version uses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowThreads = 64;     // a thread a row: rows a block
constexpr int kWarpThreads = 256;   // a warp a row: 8 rows a block
constexpr int kMaxTopK = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A row's 16 bytes at x (16-byte aligned) into p[0..4) or p[0..8).
__device__ __forceinline__ void load16(const float* x, float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(x));
  p[0] = q.x;
  p[1] = q.y;
  p[2] = q.z;
  p[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* x, float* p) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(x));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a bfloat16 is a float's upper half
    p[2 * j] = __uint_as_float(w[j] << 16);
    p[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// One thread per token row, kE >= e registers of the row (-inf past e,
// never picked). vec: the row starts 16-byte aligned and e fills whole
// 16-byte vectors.
template <typename T, int kE>
__global__ void __launch_bounds__(kRowThreads)
    router_rows(const T* __restrict__ logits, float* __restrict__ gates,
                int* __restrict__ idx, int t, int e, int k, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(kE % kVec == 0, "a row holds whole vectors");
  const long long row = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (row >= t) return;
  const T* x = logits + row * e;

  float p[kE];
  if (vec) {
#pragma unroll
    for (int v = 0; v < kE / kVec; ++v) {
      if (v * kVec < e) {
        load16(x + v * kVec, p + v * kVec);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) p[v * kVec + j] = -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j) p[j] = j < e ? to_f32(x[j]) : -INFINITY;
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kE; ++j) m = fmaxf(m, p[j]);
  // past e, exp(-inf - m) adds 0 to a finite sum (and where m is -inf
  // or +inf the row's own sum is NaN already)
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    p[j] = expf(p[j] - m);
    s += p[j];
  }
  const long long o = row * k;
  if (isnan(s)) {  // every p NaN: experts 0..k-1 (see the note above)
#pragma unroll
    for (int r = 0; r < kMaxTopK; ++r) {
      if (r < k) {
        gates[o + r] = p[r] / s;
        idx[o + r] = r;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kE; ++j) p[j] = p[j] / s;
  unsigned taken = e < kWarp ? ~0u << e : 0u;  // bit j: expert j done
  float g[kMaxTopK];
  int ix[kMaxTopK];
  float total = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxTopK; ++r) {
    if (r < k) {
      float bv = -1.0f;  // below every probability
      int bi = 0;        // k <= e leaves an untaken expert every round
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        if (!((taken >> j) & 1u) && p[j] > bv) {
          bv = p[j];
          bi = j;
        }
      }
      taken |= 1u << bi;
      g[r] = bv;
      ix[r] = bi;
      total += bv;
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxTopK; ++r) {
    if (r < k) {
      gates[o + r] = g[r] / total;
      idx[o + r] = ix[r];
    }
  }
}

// One warp per token row, lane l holding experts l, l + 32, ...
template <typename T, int kPer>
__global__ void __launch_bounds__(kWarpThreads)
    router_warps(const T* __restrict__ logits, float* __restrict__ gates,
                 int* __restrict__ idx, int t, int e, int k) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row = ((long long)blockIdx.x * kWarpThreads +
                         threadIdx.x) / kWarp;
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

  if (isnan(s)) {  // the whole warp: every p NaN, experts 0..k-1
    if (lane < k) {
      gates[row * k + lane] = p[0];
      idx[row * k + lane] = lane;
    }
    return;
  }

  unsigned taken = 0u;  // bit j: expert lane + 32 j already chosen
  float total = 0.0f;
  float my_gate = 0.0f;  // lane r keeps round r's pick
  int my_idx = 0;
  for (int r = 0; r < k; ++r) {
    float bv = -1.0f;  // below every probability: nothing yet
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = lane + kWarp * j;
      if (c < e && !((taken >> j) & 1u) && p[j] > bv) {
        bv = p[j];
        bi = c;
      }
    }
    // a lane with nothing (-1, INT_MAX) never wins against a pick
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    // k <= e: some lane had an untaken expert, so bi is one
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
int launch(const T* logits, void* out, int t, int e, int k, void* stream) {
  if (t < 0 || e < 1 || e > 12 * kWarp || k < 1 || k > kMaxTopK || k > e)
    return (int)cudaErrorInvalidValue;
  if (t == 0) return 0;
  // out is (2, T, k) int32: the gates (as float32) then the indices
  float* gates = static_cast<float*>(out);
  int* idx = static_cast<int*>(out) + (long long)t * k;
  cudaStream_t st = (cudaStream_t)stream;
  if (e <= kWarp) {
    const bool vec = e % (16 / (int)sizeof(T)) == 0 &&
                     reinterpret_cast<uintptr_t>(logits) % 16 == 0;
    const dim3 grid(
        (unsigned)(((long long)t + kRowThreads - 1) / kRowThreads));
    if (e <= 8)
      router_rows<T, 8><<<grid, kRowThreads, 0, st>>>(logits, gates, idx,
                                                      t, e, k, vec);
    else if (e <= 16)
      router_rows<T, 16><<<grid, kRowThreads, 0, st>>>(logits, gates, idx,
                                                       t, e, k, vec);
    else
      router_rows<T, 32><<<grid, kRowThreads, 0, st>>>(logits, gates, idx,
                                                       t, e, k, vec);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)(((long long)t * kWarp + kWarpThreads - 1) /
                             kWarpThreads));
  if (e <= 2 * kWarp)
    router_warps<T, 2><<<grid, kWarpThreads, 0, st>>>(logits, gates, idx,
                                                      t, e, k);
  else if (e <= 4 * kWarp)
    router_warps<T, 4><<<grid, kWarpThreads, 0, st>>>(logits, gates, idx,
                                                      t, e, k);
  else
    router_warps<T, 12><<<grid, kWarpThreads, 0, st>>>(logits, gates, idx,
                                                       t, e, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int moe_router_f32_launch(const float* logits, void* out, int t,
                                     int e, int k, void* stream) {
  return launch(logits, out, t, e, k, stream);
}

extern "C" int moe_router_bf16_launch(const __nv_bfloat16* logits,
                                      void* out, int t, int e, int k,
                                      void* stream) {
  return launch(logits, out, t, e, k, stream);
}
