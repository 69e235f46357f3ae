"""Launch wrapper of the CUDA MoE router (``csrc/moe_router.cu``):
checks, allocates, launches, counts.

It runs once a layer in every forward of a MoE model, each decode step
included, so the call is kept light: the checks in one pass before
anything is built or launched, one allocation for both outputs, the
stream's raw handle."""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (count_launch, raise_on_error,
                                        raw_stream)
from repro_torch.kernels.moe_router.ops import check_router_args

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {torch.float32: "moe_router_f32_launch",
          torch.bfloat16: "moe_router_bf16_launch"}


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("moe_router"), _ENTRY[dtype])
    fn.argtypes = [_P, _P, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def moe_router_kernel(logits: torch.Tensor, top_k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) float32 or bfloat16, contiguous on a CUDA device,
    E <= 384, 1 <= k <= min(8, E) -> gates (T, k) float32, indices (T, k)
    int32: the two planes of one (2, T, k) int32 buffer, the gates viewed
    as float32. One launch: a thread a token row for E <= 32, a warp a
    row above."""
    check_router_args(logits, top_k)
    if not logits.is_contiguous():
        raise ValueError("logits: not contiguous")
    if not logits.is_cuda:
        raise ValueError(f"logits: on {logits.device}, expected CUDA")
    t, e = logits.shape
    out = torch.empty((2, t, top_k), dtype=torch.int32,
                      device=logits.device)
    code = _fn(logits.dtype)(logits.data_ptr(), out.data_ptr(), t, e,
                             top_k, raw_stream(logits))
    raise_on_error(code, "moe_router")
    count_launch("moe_router")
    return out[0].view(torch.float32), out[1]
