// RWKV6 WKV recurrence (exclusive convention with the u bonus), forward.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py,
// rwkv6_scan_kernel (body _kernel): for every (batch, head), from C_0 = 0,
//   y_t = r_t . C_{t-1} + (r_t . (u o k_t)) v_t
//   C_t = diag(exp(log_w_t)) C_{t-1} + k_t v_t^T
// with r, k (T, 64) and v (T, 64) in float32 or bfloat16, log_w (T, 64)
// and u (64,) float32. It returns y (T, 64) and the final state C_T
// (64, 64), both float32.
//
// Bound on the H100 at the serve path's prompt shape (B, H, T, dk, dv) =
// (8, 32, 512, 64, 64), bf16 r/k/v: the function must read r, k, v
// (50.3 MB), log_w (33.6 MB) and write y (33.6 MB) and the final state
// (4.2 MB), 121.6 MB, 36.3 us at 3.35 TB/s; it does about four float32
// operations per state element and step, 2.15 GFLOP, 32 us at 67 TFLOP/s.
// Bytes bound it, but only just: the recurrence is sequential in t, so
// the work a block can overlap is one step of one head.
//
// Design: the sequential recurrence, not the TPU's chunked MXU form (which
// carries exp(-cumsum(log_w)) factors that grow within a chunk). One
// block of 256 threads per (batch, head); thread (g, j) holds rows
// 16 g .. 16 g + 15 of column j of the 64 x 64 float32 state in
// registers. The block stages 16 steps of r, k, exp(log_w) and v in
// shared memory (exp taken once per element, not once per thread), walks
// them in order with no barrier between steps, writes each step's four
// partial sums of y to shared memory and adds them after the 16 steps.
// Steps past T have k = v = 0 and decay 1, so they leave the state as it
// is. y and the final state are written as coalesced rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;         // dk = dv
constexpr int kGroups = 4;     // row groups of the state
constexpr int kRows = kD / kGroups;
constexpr int kThreads = kGroups * kD;
constexpr int kSteps = 16;     // steps staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ log_w,
                      const float* __restrict__ u, float* __restrict__ y,
                      float* __restrict__ fin, int h, int t_len) {
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
  const int bh = blockIdx.x;            // b * h + head
  const int head = bh % h;
  const long long base = (long long)bh * t_len * kD;

  float c[kRows], uu[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    c[i] = 0.0f;
    uu[i] = u[head * kD + g * kRows + i];
  }

  for (int t0 = 0; t0 < t_len; t0 += kSteps) {
    __syncthreads();  // the previous chunk's steps and sums are done
    for (int e = tid; e < kSteps * kD; e += kThreads) {
      const int tt = e / kD, i = e % kD;
      const bool in = t0 + tt < t_len;
      const long long o = base + (long long)(t0 + tt) * kD + i;
      sr[e] = in ? to_f32(r[o]) : 0.0f;
      sk[e] = in ? to_f32(k[o]) : 0.0f;
      sw[e] = in ? expf(log_w[o]) : 1.0f;
      sv[tt][i] = in ? to_f32(v[o]) : 0.0f;
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
    for (int e = tid; e < kSteps * kD; e += kThreads) {
      const int tt = e / kD, jj = e % kD;
      if (t0 + tt < t_len)
        y[base + (long long)(t0 + tt) * kD + jj] =
            (sy[0][tt][jj] + sy[1][tt][jj]) + (sy[2][tt][jj] + sy[3][tt][jj]);
    }
  }
  float* fb = fin + (long long)bh * kD * kD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) fb[(g * kRows + i) * kD + j] = c[i];
}

template <typename T>
int launch(const T* r, const T* k, const T* v, const float* log_w,
           const float* u, float* y, float* fin, int b, int h, int t_len,
           int dk, int dv, void* stream) {
  if (dk != kD || dv != kD) return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return 0;
  rwkv6_scan_kernel<T><<<b * h, kThreads, 0, (cudaStream_t)stream>>>(
      r, k, v, log_w, u, y, fin, h, t_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_scan_f32_launch(const float* r, const float* k,
                                     const float* v, const float* log_w,
                                     const float* u, float* y, float* fin,
                                     int b, int h, int t_len, int dk, int dv,
                                     void* stream) {
  return launch<float>(r, k, v, log_w, u, y, fin, b, h, t_len, dk, dv,
                       stream);
}

extern "C" int rwkv6_scan_bf16_launch(const void* r, const void* k,
                                      const void* v, const float* log_w,
                                      const float* u, float* y, float* fin,
                                      int b, int h, int t_len, int dk, int dv,
                                      void* stream) {
  using B = __nv_bfloat16;
  return launch<B>(static_cast<const B*>(r), static_cast<const B*>(k),
                   static_cast<const B*>(v), log_w, u, y, fin, b, h, t_len,
                   dk, dv, stream);
}
