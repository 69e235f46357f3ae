"""Launch wrapper of Random's scan (``csrc/random_assign.cu``): checks,
allocates, launches, counts.

A lane of the seed's warp holds up to 8 ESs' budgets in registers, so
the kernel takes at most ``MAX_ES`` edge servers; the wrapper refuses
more before it builds or launches anything.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (check, count_launch,
                                        raise_on_error, raw_stream)

MAX_ES = 256

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("random_assign").random_assign_launch
    fn.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    fn.restype = _I
    return fn


def random_assign_kernel(order: torch.Tensor, gumbel: torch.Tensor,
                         costs: torch.Tensor, budgets: torch.Tensor,
                         eligible: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """order (S, N) int32, gumbel (S, N, M) float32, costs (S, N) float32,
    budgets (S, M) float32, eligible (S, N, M) bool, on one CUDA device
    -> (assign (S, N) int32, -1 = unselected; remaining (S, M) float32).
    ``order`` must be a permutation of 0..N-1 in every row."""
    if gumbel.dim() != 3:
        raise ValueError(f"gumbel: {gumbel.dim()} dims, expected (S, N, M)")
    s, n, m = gumbel.shape
    if m > MAX_ES:
        raise ValueError(f"random_assign: M = {m} edge servers; a lane "
                         f"holds 8 budgets, so the kernel takes at most "
                         f"{MAX_ES}")
    check(order, "order", torch.int32, (s, n))
    check(gumbel, "gumbel", torch.float32, (s, n, m))
    check(costs, "costs", torch.float32, (s, n))
    check(budgets, "budgets", torch.float32, (s, m))
    check(eligible, "eligible", torch.bool, (s, n, m))
    assign = torch.empty((s, n), dtype=torch.int32, device=gumbel.device)
    remaining = torch.empty((s, m), dtype=torch.float32,
                            device=gumbel.device)
    if s == 0:
        return assign, remaining
    code = _fn()(order.data_ptr(), gumbel.data_ptr(), costs.data_ptr(),
                 budgets.data_ptr(), eligible.data_ptr(), assign.data_ptr(),
                 remaining.data_ptr(), s, n, m, raw_stream(gumbel))
    raise_on_error(code, "random_assign")
    count_launch("random_assign")
    return assign, remaining
