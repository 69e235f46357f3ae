"""B4's bf16 kernel with P as one bf16 product, against the shipped kernel
that splits P into P_hi + P_lo and multiplies both by V.

The variant is built from ``src/repro_torch/csrc/flash_attention.cu``
with the P_lo product taken out; the package is not changed. For each of
``chip_smoke.py`` phase 6's bf16 cases (qwen2-1.5b's prompt at windows 0
and 128, mixtral-8x22b's at window 4096, on the model layout's views)
it prints both kernels' max abs error against the plain float32 version,
their margin under ``FLASH_TOL["bf16"]``, and both times (CUDA events,
L2 flushed, run as split, single, single, split).

Needs a CUDA card and nvcc. From the root of the repo:
    PYTHONPATH=src python3 tools/flash_p_split.py
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.common import view_strides  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

LO_PRODUCT = "        wgmma_rs_n64_tb(o[c], plo[kk], db);\n"
LO_PIN = "    pin(plo);\n"
CASES = (("qwen2-1.5b, window 0", (8, 512, 12, 2, 128), 0, 7),
         ("qwen2-1.5b, window 128", (8, 512, 12, 2, 128), 128, 135),
         ("mixtral-8x22b, window 4096", (8, 512, 48, 8, 128), 4096, 13))


def build_single() -> ctypes.CDLL:
    """The kernel's source without the P_lo product, built with the
    package's own flags into ``build/flash_p_split``."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    if src.count(LO_PRODUCT) != 1 or src.count(LO_PIN) != 2:
        raise SystemExit("flash_attention.cu no longer has the P_lo "
                         "product this script removes")
    out = os.path.join(ROOT, "build", "flash_p_split")
    os.makedirs(out, exist_ok=True)
    cu, lib = os.path.join(out, "single.cu"), os.path.join(out, "single.so")
    with open(cu, "w") as f:
        f.write(src.replace(LO_PRODUCT, "").replace(LO_PIN, ""))
    built = subprocess.run([_build._nvcc(), *_build.flags("flash_attention"),
                            "-o", lib, cu], capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"nvcc failed:\n{built.stdout}{built.stderr}")
    dll = ctypes.CDLL(lib)
    dll.flash_attention_bf16_launch.argtypes = \
        fk._fn(torch.bfloat16).argtypes
    dll.flash_attention_bf16_launch.restype = ctypes.c_int
    return dll


def single(dll, q, k, v, window):
    """The variant, called as ``flash_attention_kernel`` calls the
    shipped entry (causal, sm_scale 1 / sqrt(D))."""
    b, h, s, d = q.shape
    strides = [st for name, t in (("q", q), ("k", k), ("v", v))
               for st in view_strides(t, name, fk.STRIDE_ALIGN)]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    code = dll.flash_attention_bf16_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        fk._Strides(*strides), b, h, k.shape[1], s, d, 1, window,
        1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if code:
        raise SystemExit(f"single-product launch failed: {code}")
    return out.transpose(1, 2)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dll = build_single()
    tol = cs.FLASH_TOL["bf16"]
    for what, (b, s, h, kv, d), window, seed in CASES:
        q, k, v = cs.flash_views("cuda", b, s, h, kv, d, torch.bfloat16,
                                 seed)
        f32 = torch.float32
        want = attention_ref(q.to(f32), k.to(f32), v.to(f32), causal=True,
                             window=window)
        calls = {"split": lambda: fk.flash_attention_kernel(
                     q, k, v, causal=True, window=window),
                 "single": lambda: single(dll, q, k, v, window)}
        errs = {n: (c().to(f32) - want).abs().max().item()
                for n, c in calls.items()}
        ms = {n: [] for n in calls}
        for n in ("split", "single", "single", "split"):
            ms[n].append(cs.event_ms(calls[n]))
        for n in calls:
            print(f"{what}: P {n:6s} max abs err {errs[n]:.3e} (margin "
                  f"{tol / errs[n]:.2f}x under {tol}), "
                  + ", ".join(f"{t * 1e3:.2f}" for t in ms[n]) + " us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
