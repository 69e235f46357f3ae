// Tile-local density sort for the budgeted top-k (P2 density greedy).
//
// Replaces the TPU kernel src/repro/kernels/budgeted_topk/kernel.py,
// density_sort_kernel (body _kernel, network bitonic_sort_desc): for each
// client tile, the P2 density value / max(cost, 1e-12), -inf where the
// pair is not eligible, and a sort of the tile's tile*M candidates by
// (density descending, flat index descending), padded with (-inf, -1) up
// to the next power of two P. Output: one sorted segment per tile,
// (S, num_tiles, P) densities and int32 flat indices.
//
// Bound on the H100: neither bytes nor arithmetic at this size. A tile of
// 128 clients x 12 ES reads about 13 KB and writes 16 KB; the sort does
// P/2 * log2(P) * (log2(P) + 1) / 2 compare-exchanges (67,584 for P =
// 2048), all in shared memory. What costs is the barrier between the
// log2(P) * (log2(P) + 1) / 2 stages (66 at P = 2048). The design keeps
// the whole segment, keys and indices, in shared memory (P * 8 B = 16 KB)
// for one thread block per (seed, tile), one thread per compare-exchange
// pair (1024 threads at P = 2048), and one __syncthreads() per stage; all
// seeds and tiles go in one launch, so the card runs S * num_tiles blocks
// side by side.
//
// The order is a strict total order (flat indices are unique; only pads
// compare equal, and pads are identical), so any correct sorting network
// gives the same output; this one is the TPU kernel's network stage for
// stage. Densities use IEEE division (nvcc's default -prec-div=true) and
// are bitwise those of the plain version.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void density_sort_kernel(const float* __restrict__ values,
                                    const float* __restrict__ costs,
                                    const unsigned char* __restrict__ eligible,
                                    float* __restrict__ out_d,
                                    int* __restrict__ out_i, int n, int m,
                                    int tile, int p, int ntiles) {
  extern __shared__ unsigned char smem[];
  float* sd = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sd + p);
  const int seed = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    float d = -CUDART_INF_F;
    int ix = -1;
    if (q < tile * m) {
      int client = t0 + q / m;
      int col = q % m;
      ix = client * m + col;
      if (client < n) {
        long long o = ((long long)seed * n + client) * m + col;
        if (eligible[o]) {
          d = values[o] / fmaxf(costs[(long long)seed * n + client], 1e-12f);
        }
      }
    }
    sd[q] = d;
    si[q] = ix;
  }
  __syncthreads();
  const int half = p >> 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        int a = 2 * j * (t / j) + (t % j);
        int b = a + j;
        float da = sd[a], db = sd[b];
        int ia = si[a], ib = si[b];
        bool a_first = (da > db) || (da == db && ia >= ib);
        bool desc = (a & k) == 0;
        if (desc != a_first) {
          sd[a] = db; sd[b] = da;
          si[a] = ib; si[b] = ia;
        }
      }
      __syncthreads();
    }
  }
  long long base = ((long long)seed * ntiles + blockIdx.x) * p;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    out_d[base + q] = sd[q];
    out_i[base + q] = si[q];
  }
}

}  // namespace

extern "C" int density_sort_launch(const float* values, const float* costs,
                                   const unsigned char* eligible,
                                   float* out_d, int* out_i, int s, int n,
                                   int m, int tile, int p, void* stream) {
  int ntiles = (n + tile - 1) / tile;
  if (s == 0 || ntiles == 0) return 0;
  size_t smem = (size_t)p * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        density_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = p / 2 < 1024 ? (p / 2 > 32 ? p / 2 : 32) : 1024;
  dim3 grid(ntiles, s);
  density_sort_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      values, costs, eligible, out_d, out_i, n, m, tile, p, ntiles);
  return (int)cudaGetLastError();
}
