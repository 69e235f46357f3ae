"""Launch wrapper of the CUDA RWKV6 WKV scan (``csrc/rwkv6_scan.cu``):
checks, allocates, launches, counts.

r, k, v and log_w come in as strided views, so the model's (B, T, H, 64)
tensors are passed transposed without a copy; y is allocated in the
model's layout and returned as its (B, H, T, 64) view. bfloat16 r/k/v run
the chunked tensor-core kernel, float32 the sequential kernel."""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (check, count_launch,
                                        raise_on_error, view_strides)

_P, _I = ctypes.c_void_p, ctypes.c_int
HEAD_DIM = 64
TMA_ALIGN = 16               # bytes: TMA's base pointers and strides
_ENTRY = {torch.float32: "rwkv6_scan_f32_launch",
          torch.bfloat16: "rwkv6_scan_bf16_launch"}
_Strides = ctypes.c_longlong * 12


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("rwkv6_scan"), _ENTRY[dtype])
    fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def chunked_smem_bytes() -> int:
    """Dynamic shared memory of one block of the bf16 kernel, as it
    launches (two stages of r, k, v and log_w, the decays, the scores and
    two state buffers)."""
    fn = _build.load("rwkv6_scan").rwkv6_scan_bf16_smem
    fn.argtypes = []
    fn.restype = _I
    return fn()


def rwkv6_scan_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_w: torch.Tensor, u: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, H, T, 64) views in float32 or bfloat16 (one dtype),
    log_w (B, H, T, 64) view and u (H, 64) contiguous, float32, on one
    CUDA device; the views' last dim unit-stride, and in bfloat16 (read
    through TMA) their other strides and base pointers 16-byte aligned ->
    y (B, H, T, 64), the transposed view of a contiguous (B, T, H, 64)
    tensor, and the final state (B, H, 64, 64), float32. One launch, one
    block per (batch, head)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if r.dtype not in _ENTRY:
        raise TypeError(f"r: dtype {r.dtype}, expected one of "
                        f"{list(_ENTRY)}")
    if dk != HEAD_DIM or dv != HEAD_DIM:
        raise ValueError(f"head dims ({dk}, {dv}); the kernel takes "
                         f"({HEAD_DIM}, {HEAD_DIM})")
    named = (("r", r, r.dtype), ("k", k, r.dtype), ("v", v, r.dtype),
             ("log_w", log_w, torch.float32))
    tma = r.dtype == torch.bfloat16
    strides = []
    for name, x, dtype in named:
        if not x.is_cuda:
            raise ValueError(f"{name}: on {x.device}, expected CUDA")
        if x.dtype != dtype:
            raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != (b, h, t, HEAD_DIM):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{(b, h, t, HEAD_DIM)}")
        if tma and x.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name}: data pointer not {TMA_ALIGN}-byte "
                             f"aligned")
        strides += view_strides(
            x, name, TMA_ALIGN // x.element_size() if tma else 1)
    check(u, "u", torch.float32, (h, dk))
    y = torch.empty((b, t, h, dv), dtype=torch.float32, device=r.device)
    fin = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    code = _fn(r.dtype)(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        log_w.data_ptr(), u.data_ptr(), y.data_ptr(),
                        fin.data_ptr(), _Strides(*strides), b, h, t, dk, dv,
                        torch.cuda.current_stream(r.device).cuda_stream)
    raise_on_error(code, "rwkv6_scan")
    count_launch("rwkv6_scan")
    return y.transpose(1, 2), fin
