"""Launch wrapper of the CUDA masked aggregation
(``csrc/masked_aggregate.cu``): checks, allocates, launches, counts."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (check, count_launch,
                                        raise_on_error, raw_stream)

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_SLOTS = 12 * 1024 - 1    # the weights and the denominator in 48 KB


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("masked_aggregate").masked_aggregate_launch
    fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    fn.restype = _I
    return fn


def masked_aggregate_kernel(params: torch.Tensor, deltas: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """params (R, D), deltas (R, S, D), weights (R, S), float32 on one
    CUDA device -> (R, D), one launch for all rows."""
    r, s, d = deltas.shape
    if s > MAX_SLOTS:
        raise ValueError(f"{s} slots exceed the kernel's weight table "
                         f"({MAX_SLOTS})")
    check(params, "params", torch.float32, (r, d))
    check(deltas, "deltas", torch.float32, (r, s, d))
    check(weights, "weights", torch.float32, (r, s))
    out = torch.empty((r, d), dtype=torch.float32, device=params.device)
    code = _fn()(params.data_ptr(), deltas.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), r, s, d,
                 raw_stream(params))
    raise_on_error(code, "masked_aggregate")
    count_launch("masked_aggregate")
    return out
