"""Launch wrapper of the one-pass P2 selection kernel
(``csrc/budgeted_topk.cu``): checks, allocates, launches, counts.

The kernel keeps a seed's candidate pairs in shared memory, so it takes
at most ``MAX_PAIRS`` pairs (N * M) a seed; the wrapper refuses more
before it builds or launches anything.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (check, count_launch,
                                        raise_on_error)

MAX_PAIRS = 16384

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("budgeted_topk")
    lib.budgeted_topk_launch.argtypes = [_P] * 6 + [_I] * 3 + [_P]
    lib.budgeted_topk_launch.restype = _I
    lib.budgeted_topk_smem.argtypes = [_I, _I]
    lib.budgeted_topk_smem.restype = ctypes.c_longlong
    return lib


def smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of the kernel's block at N clients, M ES."""
    return int(_lib().budgeted_topk_smem(n, m))


def budgeted_topk_kernel(values: torch.Tensor, costs: torch.Tensor,
                         budgets: torch.Tensor, eligible: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """values (S, N, M) float32, costs (S, N) float32, budgets (S, M)
    float32, eligible (S, N, M) bool, on one CUDA device -> (assign (S, N)
    int32, -1 = unselected; remaining (S, M) float32)."""
    if values.dim() != 3:
        raise ValueError(f"values: {values.dim()} dims, expected (S, N, M)")
    s, n, m = values.shape
    if n * m > MAX_PAIRS:
        raise ValueError(
            f"budgeted_topk: N * M = {n} * {m} = {n * m} candidate pairs a "
            f"seed; the kernel holds a seed's pairs in shared memory and "
            f"takes at most {MAX_PAIRS}")
    args = ((values, "values", torch.float32, (s, n, m)),
            (costs, "costs", torch.float32, (s, n)),
            (budgets, "budgets", torch.float32, (s, m)),
            (eligible, "eligible", torch.bool, (s, n, m)))
    for a in args:
        check(*a, cuda=False)
    for t, name, *_ in args:
        if not t.is_cuda:
            raise ValueError(f"{name}: on {t.device}, expected CUDA")
    assign = torch.empty((s, n), dtype=torch.int32, device=values.device)
    remaining = torch.empty((s, m), dtype=torch.float32,
                            device=values.device)
    if s == 0:
        return assign, remaining
    code = _lib().budgeted_topk_launch(
        values.data_ptr(), costs.data_ptr(), budgets.data_ptr(),
        eligible.data_ptr(), assign.data_ptr(), remaining.data_ptr(), s, n,
        m, torch.cuda.current_stream(values.device).cuda_stream)
    raise_on_error(code, "budgeted_topk")
    count_launch("budgeted_topk")
    return assign, remaining
