"""Launch wrapper of the CUDA flash attention
(``csrc/flash_attention.cu``): checks, allocates, launches, counts."""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (check, count_launch,
                                        raise_on_error)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
HEAD_DIMS = (64, 128)        # the reduced configs and qwen2-1.5b
_ENTRY = {torch.float32: "flash_attention_f32_launch",
          torch.bfloat16: "flash_attention_bf16_launch"}


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("flash_attention"), _ENTRY[dtype])
    fn.argtypes = [_P] * 4 + [_I] * 7 + [_F, _P]
    fn.restype = _I
    return fn


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           window: int = 0, sm_scale: float = 0.0
                           ) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, KV, S, D), float32 or bfloat16, one dtype,
    contiguous on one CUDA device, H % KV == 0, D in ``HEAD_DIMS`` -> out
    like q. One launch for all (batch, head, query tile)."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    if q.dtype not in _ENTRY:
        raise TypeError(f"q: dtype {q.dtype}, expected one of "
                        f"{list(_ENTRY)}")
    if h % kv:
        raise ValueError(f"{h} query heads do not split over {kv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or {h} heads exceed the grid's 65535")
    check(q, "q", q.dtype, (b, h, s, d))
    check(k, "k", q.dtype, (b, kv, s, d))
    check(v, "v", q.dtype, (b, kv, s, d))
    if sm_scale == 0.0:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    code = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, h, kv, s, d, int(causal),
                        int(window), sm_scale,
                        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(code, "flash_attention")
    count_launch("flash_attention")
    return out
