// RWKV6 WKV recurrence (exclusive convention with the u bonus), backward:
// the gradients of rwkv6_scan.cu's y and final state with respect to r,
// k, v, log_w and u.
//
// Replaces no TPU kernel: the JAX package trains by XLA autodiff of its
// jnp recurrence and never differentiates its Pallas kernel
// (src/repro/kernels/rwkv6_scan/kernel.py has no backward). The port's
// training forward runs the hand kernel, whose outputs have no autograd
// history, so its gradient is this hand kernel too (ops.py's
// autograd.Function). With the state C in R^{64 x 64}, C_{-1} = 0,
//   C_t = diag(w_t) C_{t-1} + k_t v_t^T,   w_t = exp(log_w_t)
//   y_t = r_t . C_{t-1} + (r_t . (u o k_t)) v_t
// and dC the incoming gradient of the final state (or 0), walking t
// backwards with G = dL/dC_t:
//   dr_t = C_{t-1} dy_t + (u o k_t)(v_t . dy_t)
//   dk_t = G v_t + (r_t o u)(v_t . dy_t)
//   dv_t = G^T k_t + (r_t . (u o k_t)) dy_t
//   dlog_w_t = w_t o rowsum(G o C_{t-1})
//   du += r_t o k_t (v_t . dy_t)
//   G <- diag(w_t) G + r_t dy_t^T
// No state is ever stepped backwards by dividing by w (every factor stays
// <= 1, as in the forward): the states are recomputed forwards from
// checkpoints.
//
// Layout: r, k, v (float32 or bf16), log_w and dy (float32) are strided
// (B, H, T, 64) views (unit-stride last dim), as the forward takes them;
// dr, dk, dv (the inputs' dtype) and dlog_w (float32) are written in the
// model's (B, T, H, 64) layout, contiguous; du (H, 64) float32.
//
// Bound on the H100 at rwkv6-1.6b's training shape (B, H, T) = (4, 32,
// 512), bf16 r/k/v: it must read r, k, v (25.2 MB), log_w and dy (33.6
// MB) and write dr, dk, dv (25.2 MB) and dlog_w (16.8 MB), 100.7 MB,
// 30.1 us at 3.35 TB/s; it needs six 64 x 64 multiply-adds a step (the
// state, C dy, G v, G^T k, rowsum(G o C), the step of G), 12 x 4096 x
// B H T = 3.22 GFLOP, 48.1 us at the float32 rate: operations bound it.
// This kernel recomputes each state once more and walks the steps one at
// a time (a barrier and a global load a step), expected far from that
// bound (PERF.md).
//
// Design (simple and correct first):
//  - One block of 256 threads per (batch, head); thread tid owns row i =
//    tid / 4 of C and of G, columns 16 (tid % 4) .. + 15, in registers,
//    so a row's reductions (dr, dk, dlog_w, v . dy) are two shuffles over
//    its 4 lanes, and dv's column sums three shuffles down a warp and 8
//    warps' partials in shared memory (double-buffered: one barrier a
//    step).
//  - Pass 1 walks t forwards and writes C_{t-1} at every 64th step, a
//    checkpoint, to global scratch (B H ceil(T / 64) x 16 KB). Pass 2
//    walks the chunks of 64 steps backwards: it stages the chunk's r, k,
//    v, w and dy in shared memory (80 KB), recomputes the chunk's 64
//    states from its checkpoint into a per-block global buffer (1 MB;
//    each thread writes and reads back only its own 64 bytes a step,
//    a step ahead of its use), then runs the reverse steps above.
//  - du: a block's partial sum over its t, (B, H, 64), then a second
//    launch sums the partials over b in order; deterministic, no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kC = 64;          // checkpoint interval: the chunk of steps
constexpr int kThreads = 256;
constexpr int kCols = 16;       // columns of C a thread owns
constexpr int kWarps = kThreads / 32;
constexpr int kState = kD * kD;
// shared memory: r, k, v, w, dy of a chunk; u; v . dy and r . (u o k) of
// each step; dv's per-warp partials, two buffers
constexpr int kSmemFloats = 5 * kC * kD + kD + 2 * kC + 2 * kWarps * kD;
constexpr size_t kSmem = sizeof(float) * kSmemFloats;

// element strides over (batch, head, step) of r, k, v, log_w, dy
struct Strides {
  long long r[3], k[3], v[3], w[3], g[3];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void store16(float* dst, const float (&x)[kCols]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q)
    d4[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

__device__ __forceinline__ void load16(const float* src, float (&x)[kCols]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q) {
    const float4 a = s4[q];
    x[4 * q] = a.x;
    x[4 * q + 1] = a.y;
    x[4 * q + 2] = a.z;
    x[4 * q + 3] = a.w;
  }
}

// the sum over a row's 4 lanes
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// steps t0 .. t0 + len - 1 of a (T, 64) view with step stride `ts` into a
// (kC, 64) shared tile; `exp_of` stores exp(x) (the decay from log_w)
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ts,
                                      int t0, int len, bool exp_of = false) {
  for (int e = threadIdx.x; e < len * kD; e += kThreads) {
    const int m = e / kD, c = e % kD;
    const float x = ld(src + (long long)(t0 + m) * ts + c);
    dst[e] = exp_of ? expf(x) : x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    rwkv6_scan_bwd(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ log_w,
                   const float* __restrict__ u, const float* __restrict__ dy,
                   const float* __restrict__ dfin, T* __restrict__ dr,
                   T* __restrict__ dk, T* __restrict__ dv,
                   float* __restrict__ dlw, float* __restrict__ du_part,
                   float* __restrict__ ckpt, float* __restrict__ buf,
                   Strides st, int h, int t_len) {
  extern __shared__ float4 smem4[];
  float* sr = reinterpret_cast<float*>(smem4);
  float* sk = sr + kC * kD;
  float* sv = sk + kC * kD;
  float* sw = sv + kC * kD;     // w = exp(log_w)
  float* sg = sw + kC * kD;     // dy
  float* su = sg + kC * kD;
  float* svdy = su + kD;        // v_t . dy_t
  float* sruk = svdy + kC;      // r_t . (u o k_t)
  float* spart = sruk + kC;     // [2][kWarps][kD]

  const int blk = blockIdx.x;
  const int bb = blk / h;
  const int hh = blk % h;
  const int tid = threadIdx.x;
  const int i = tid >> 2;
  const int j0 = (tid & 3) * kCols;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nc = (t_len + kC - 1) / kC;

  const T* rb = r + bb * st.r[0] + hh * st.r[1];
  const T* kb = k + bb * st.k[0] + hh * st.k[1];
  const T* vb = v + bb * st.v[0] + hh * st.v[1];
  const float* wb = log_w + bb * st.w[0] + hh * st.w[1];
  const float* gb = dy + bb * st.g[0] + hh * st.g[1];
  float* ck = ckpt + (long long)blk * nc * kState + tid * kCols;
  float* bf = buf + (long long)blk * kC * kState + tid * kCols;
  if (tid < kD) su[tid] = u[hh * kD + tid];

  // pass 1: checkpoints C_{t0 - 1} at t0 = 64 c
  float cs[kCols];
#pragma unroll
  for (int jj = 0; jj < kCols; ++jj) cs[jj] = 0.0f;
  for (int c = 0; c < nc; ++c) {
    store16(ck + (long long)c * kState, cs);
    if (c == nc - 1) break;
    __syncthreads();
    stage(sk, kb, st.k[2], c * kC, kC);
    stage(sv, vb, st.v[2], c * kC, kC);
    stage(sw, wb, st.w[2], c * kC, kC, true);
    __syncthreads();
    for (int m = 0; m < kC; ++m) {
      const float w = sw[m * kD + i], kk = sk[m * kD + i];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj)
        cs[jj] = w * cs[jj] + kk * sv[m * kD + j0 + jj];
    }
  }

  // pass 2: the chunks backwards
  float G[kCols];
  if (dfin != nullptr) {
    load16(dfin + (long long)blk * kState + i * kD + j0, G);
  } else {
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) G[jj] = 0.0f;
  }
  float du_acc = 0.0f;
  int parity = 0;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kC;
    const int len = min(kC, t_len - t0);
    __syncthreads();  // the previous chunk's tiles are read
    stage(sr, rb, st.r[2], t0, len);
    stage(sk, kb, st.k[2], t0, len);
    stage(sv, vb, st.v[2], t0, len);
    stage(sw, wb, st.w[2], t0, len, true);
    stage(sg, gb, st.g[2], t0, len);
    __syncthreads();
    if (tid < len) {
      float vd = 0.0f, ruk = 0.0f;
      for (int c2 = 0; c2 < kD; ++c2) {
        vd = fmaf(sv[tid * kD + c2], sg[tid * kD + c2], vd);
        ruk = fmaf(sr[tid * kD + c2] * su[c2], sk[tid * kD + c2], ruk);
      }
      svdy[tid] = vd;
      sruk[tid] = ruk;
    }
    // the chunk's states: slot m holds C_{t0 + m - 1}
    load16(ck + (long long)c * kState, cs);
    for (int m = 0; m < len; ++m) {
      store16(bf + (long long)m * kState, cs);
      const float w = sw[m * kD + i], kk = sk[m * kD + i];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj)
        cs[jj] = w * cs[jj] + kk * sv[m * kD + j0 + jj];
    }
    __syncthreads();  // svdy, sruk
    // C_{t-1} of the step, and the next step's loaded a step ahead
    float sp[kCols], nxt[kCols];
    load16(bf + (long long)(len - 1) * kState, nxt);
    for (int m = len - 1; m >= 0; --m) {
      const int t = t0 + m;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) sp[jj] = nxt[jj];
      if (m > 0) load16(bf + (long long)(m - 1) * kState, nxt);
      const float rr = sr[m * kD + i], kk = sk[m * kD + i];
      const float w = sw[m * kD + i], ui = su[i];
      const float vd = svdy[m];
      float a_dr = 0.0f, a_dk = 0.0f, a_dl = 0.0f, part[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float g = sg[m * kD + j0 + jj];
        const float vv = sv[m * kD + j0 + jj];
        a_dr = fmaf(sp[jj], g, a_dr);
        a_dk = fmaf(G[jj], vv, a_dk);
        a_dl = fmaf(G[jj], sp[jj], a_dl);
        part[jj] = G[jj] * kk;
        G[jj] = w * G[jj] + rr * g;
      }
      a_dr = row_sum(a_dr);
      a_dk = row_sum(a_dk);
      a_dl = row_sum(a_dl);
      // dv's column sums: down the warp's 8 rows, then over the warps
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        float x = part[jj];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        part[jj] = x;
      }
      float* pbuf = spart + parity * kWarps * kD;
      if (lane < 4) {
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          pbuf[warp * kD + j0 + jj] = part[jj];
      }
      const long long out = (((long long)bb * t_len + t) * h + hh) * kD;
      if ((tid & 3) == 0) {
        put(dr + out + i, a_dr + ui * kk * vd);
        put(dk + out + i, a_dk + rr * ui * vd);
        dlw[out + i] = w * a_dl;
        du_acc = fmaf(rr * kk, vd, du_acc);
      }
      __syncthreads();
      if (tid < kD) {
        float x = 0.0f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) x += pbuf[wi * kD + tid];
        put(dv + out + tid, x + sruk[m] * sg[m * kD + tid]);
      }
      parity ^= 1;
    }
  }
  if ((tid & 3) == 0) du_part[(long long)blk * kD + i] = du_acc;
}

// du (H, 64) = the sum over b of du_part (B, H, 64), in order of b
__global__ void rwkv6_scan_bwd_du(const float* __restrict__ du_part,
                                  float* __restrict__ du, int b, int h) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= h * kD) return;
  float x = 0.0f;
  for (int bi = 0; bi < b; ++bi) x += du_part[(long long)bi * h * kD + e];
  du[e] = x;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* log_w,
           const float* u, const float* dy, const float* dfin, void* dr,
           void* dk, void* dv, float* dlw, float* du, float* du_part,
           float* ckpt, float* buf, const long long* st, int b, int h,
           int t_len, void* stream) {
  if (b == 0 || h == 0) return 0;
  if (t_len <= 0) return (int)cudaErrorInvalidValue;
  Strides str;
  for (int q = 0; q < 3; ++q) {
    str.r[q] = st[q];
    str.k[q] = st[3 + q];
    str.v[q] = st[6 + q];
    str.w[q] = st[9 + q];
    str.g[q] = st[12 + q];
  }
  cudaStream_t cs = (cudaStream_t)stream;
  const cudaError_t e = cudaFuncSetAttribute(
      rwkv6_scan_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  rwkv6_scan_bwd<T><<<b * h, kThreads, kSmem, cs>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), log_w, u, dy, dfin, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), dlw, du_part, ckpt, buf, str,
      h, t_len);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return (int)e2;
  rwkv6_scan_bwd_du<<<(h * kD + 255) / 256, 256, 0, cs>>>(du_part, du, b, h);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v (float32 or bf16 by the entry point), log_w, dy (float32):
// (B, H, T, 64) views, st their 15 element strides (r, k, v, log_w, dy;
// batch, head, step); dfin (B, H, 64, 64) contiguous float32 or null for
// a zero final-state gradient; dr, dk, dv (inputs' dtype) and dlw
// (float32) (B, T, H, 64) contiguous; du (H, 64); scratch du_part (B, H,
// 64), ckpt B H ceil(T / 64) x 4096 and buf B H x 64 x 4096 floats, all
// float32. Returns cudaGetLastError().
extern "C" int rwkv6_scan_bwd_f32_launch(
    const void* r, const void* k, const void* v, const float* log_w,
    const float* u, const float* dy, const float* dfin, void* dr, void* dk,
    void* dv, float* dlw, float* du, float* du_part, float* ckpt, float* buf,
    const long long* st, int b, int h, int t_len, void* stream) {
  return launch<float>(r, k, v, log_w, u, dy, dfin, dr, dk, dv, dlw, du,
                       du_part, ckpt, buf, st, b, h, t_len, stream);
}

extern "C" int rwkv6_scan_bwd_bf16_launch(
    const void* r, const void* k, const void* v, const float* log_w,
    const float* u, const float* dy, const float* dfin, void* dr, void* dk,
    void* dv, float* dlw, float* du, float* du_part, float* ckpt, float* buf,
    const long long* st, int b, int h, int t_len, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, log_w, u, dy, dfin, dr, dk, dv, dlw,
                               du, du_part, ckpt, buf, st, b, h, t_len,
                               stream);
}
