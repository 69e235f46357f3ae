"""Launch wrapper of the CUDA RWKV6 WKV scan (``csrc/rwkv6_scan.cu``):
checks, allocates, launches, counts."""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (check, count_launch,
                                        raise_on_error)

_P, _I = ctypes.c_void_p, ctypes.c_int
HEAD_DIM = 64
_ENTRY = {torch.float32: "rwkv6_scan_f32_launch",
          torch.bfloat16: "rwkv6_scan_bf16_launch"}


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("rwkv6_scan"), _ENTRY[dtype])
    fn.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def rwkv6_scan_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_w: torch.Tensor, u: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k (B, H, T, 64) and v (B, H, T, 64) in float32 or bfloat16 (one
    dtype), log_w (B, H, T, 64) and u (H, 64) float32, contiguous on one
    CUDA device -> y (B, H, T, 64) and the final state (B, H, 64, 64),
    float32. One launch, one block per (batch, head)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if r.dtype not in _ENTRY:
        raise TypeError(f"r: dtype {r.dtype}, expected one of "
                        f"{list(_ENTRY)}")
    if dk != HEAD_DIM or dv != HEAD_DIM:
        raise ValueError(f"head dims ({dk}, {dv}); the kernel takes "
                         f"({HEAD_DIM}, {HEAD_DIM})")
    check(r, "r", r.dtype, (b, h, t, dk))
    check(k, "k", r.dtype, (b, h, t, dk))
    check(v, "v", r.dtype, (b, h, t, dv))
    check(log_w, "log_w", torch.float32, (b, h, t, dk))
    check(u, "u", torch.float32, (h, dk))
    y = torch.empty((b, h, t, dv), dtype=torch.float32, device=r.device)
    fin = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    code = _fn(r.dtype)(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        log_w.data_ptr(), u.data_ptr(), y.data_ptr(),
                        fin.data_ptr(), b, h, t, dk, dv,
                        torch.cuda.current_stream(r.device).cuda_stream)
    raise_on_error(code, "rwkv6_scan")
    count_launch("rwkv6_scan")
    return y, fin
