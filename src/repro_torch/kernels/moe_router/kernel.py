"""Launch wrapper of the CUDA MoE router (``csrc/moe_router.cu``):
checks, allocates, launches, counts."""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (check, count_launch,
                                        raise_on_error)
from repro_torch.kernels.moe_router.ops import check_router_args

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {torch.float32: "moe_router_f32_launch",
          torch.bfloat16: "moe_router_bf16_launch"}


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("moe_router"), _ENTRY[dtype])
    fn.argtypes = [_P] * 3 + [_I] * 3 + [_P]
    fn.restype = _I
    return fn


def moe_router_kernel(logits: torch.Tensor, top_k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) float32 or bfloat16, contiguous on a CUDA device,
    E <= 384, 1 <= k <= min(8, E) -> gates (T, k) float32, indices (T, k)
    int32. One launch, one warp per token."""
    check_router_args(logits, top_k)
    t, e = logits.shape
    check(logits, "logits", logits.dtype, (t, e))
    gates = torch.empty((t, top_k), dtype=torch.float32,
                        device=logits.device)
    idx = torch.empty((t, top_k), dtype=torch.int32, device=logits.device)
    code = _fn(logits.dtype)(logits.data_ptr(), gates.data_ptr(),
                             idx.data_ptr(), t, e, top_k,
                             torch.cuda.current_stream(logits.device)
                             .cuda_stream)
    raise_on_error(code, "moe_router")
    count_launch("moe_router")
    return gates, idx
