"""Rates of the card's units that B5's design leans on: mma.sync m16n8k8
TF32 and m16n8k16 bf16 with 8 independent accumulators a warp at 4, 8
and 16 warps an SM, one dependent chain (latency), and ex2.approx.

    python3 tools/mma_rates.py       # on the GPU (nvcc, no torch)

One block an SM on all 132 SMs, timed with CUDA events; prints TFLOP/s
(ex2: G/s) and cycles an instruction a sub-partition at 1.98 GHz. The
CUDA source is built into ``build/mma_rates/``.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "mma_rates"

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
template <int CH, bool BF>
__global__ void mma_loop(float* out, int iters) {
  float d[CH][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, 7u};
  uint32_t b0 = threadIdx.x * 11u, b1 = 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (BF)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
              "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
              "r"(b1));
    }
  }
  float s = 0;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void ex2_loop(float* out, int iters) {
  float x[8];
  for (int i = 0; i < 8; ++i) x[i] = -0.001f * (threadIdx.x + i);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float y;
      asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x[i]));
      x[i] = y - 1.0f;
    }
  float s = 0;
  for (int i = 0; i < 8; ++i) s += x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <typename K>
void run(const char* name, K kern, int warps, int iters, double work,
         int per_iter) {
  float* out;
  cudaMalloc(&out, 132 * warps * 32 * 4);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  kern<<<132, warps * 32>>>(out, 10);
  cudaEventRecord(a);
  kern<<<132, warps * 32>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double instrs = 132.0 * warps * iters * per_iter;
  printf("  %s, %d warps an SM: %.1f %s, %.2f cycles an instruction a "
         "sub-partition at 1.98 GHz\n", name, warps,
         instrs * work / (ms * 1e-3) / (work > 64 ? 1e12 : 1e9),
         work > 64 ? "TFLOP/s" : "G/s", ms * 1e-3 * 1.98e9 /
         (instrs / (132.0 * 4)));
  cudaFree(out);
}
int main() {
  for (int w : {4, 8, 16}) {
    run("mma.sync m16n8k8 TF32, 8 chains", mma_loop<8, false>, w, 20000,
        2.0 * 16 * 8 * 8, 8);
    run("mma.sync m16n8k16 bf16, 8 chains", mma_loop<8, true>, w, 20000,
        2.0 * 16 * 8 * 16, 8);
  }
  run("mma.sync m16n8k8 TF32, one chain", mma_loop<1, false>, 4, 100000,
      2.0 * 16 * 8 * 8, 1);
  run("ex2.approx.ftz.f32 (32 lanes)", ex2_loop, 16, 20000, 32.0, 8);
  return cudaDeviceSynchronize() != cudaSuccess;
}
"""


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "mma_rates.cu").write_text(SOURCE)
    exe = OUT / "mma_rates"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe),
                    str(OUT / "mma_rates.cu")], check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    sys.exit(subprocess.run([str(exe)]).returncode)


if __name__ == "__main__":
    main()
