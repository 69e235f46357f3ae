"""Launch wrappers of the selection kernels: the one-pass P2 kernel
(``csrc/budgeted_topk.cu``), its keys-only launch (density and sort, for
P3) and P3's walk over those keys (``csrc/flgreedy_walk.cu``). Each
checks, allocates, launches, counts.

B2 keeps a seed's candidate pairs in shared memory, so it takes at most
``MAX_PAIRS`` pairs (N * M) a seed; the wrappers refuse more before they
build or launch anything.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.fmath import rcp
from repro_torch.kernels import _build
from repro_torch.kernels.common import (check, count_launch,
                                        raise_on_error, raw_stream)

MAX_PAIRS = 16384

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("budgeted_topk")
    lib.budgeted_topk_launch.argtypes = [_P] * 6 + [_I] * 3 + [_P]
    lib.budgeted_topk_launch.restype = _I
    lib.budgeted_topk_keys_launch.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    lib.budgeted_topk_keys_launch.restype = _I
    lib.budgeted_topk_smem.argtypes = [_I, _I]
    lib.budgeted_topk_smem.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _walk():
    fn = _build.load("flgreedy_walk").flgreedy_walk_launch
    fn.argtypes = [_P] * 7 + [_I] * 4 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


def key_capacity(n: int, m: int) -> int:
    """Key slots a seed of the keys-only launch: a power of two >= N * M,
    at least 256 (the kernel's shared-memory key table)."""
    cap = 256
    while cap < n * m:
        cap *= 2
    return cap


def _check_pairs(n: int, m: int) -> None:
    if n * m > MAX_PAIRS:
        raise ValueError(
            f"budgeted_topk: N * M = {n} * {m} = {n * m} candidate pairs a "
            f"seed; the kernel holds a seed's pairs in shared memory and "
            f"takes at most {MAX_PAIRS}")


def _check_cuda(args) -> None:
    for a in args:
        check(*a, cuda=False)
    for t, name, *_ in args:
        if not t.is_cuda:
            raise ValueError(f"{name}: on {t.device}, expected CUDA")


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
    _check_pairs(n, m)
    _check_cuda(((values, "values", torch.float32, (s, n, m)),
                 (costs, "costs", torch.float32, (s, n)),
                 (budgets, "budgets", torch.float32, (s, m)),
                 (eligible, "eligible", torch.bool, (s, n, m))))
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


def budgeted_topk_keys_kernel(values: torch.Tensor, costs: torch.Tensor,
                              eligible: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2's density and sort without its walk: values (S, N, M) float32,
    costs (S, N) float32, eligible (S, N, M) bool on one CUDA device ->
    (keys (S, key_capacity) int64, each seed's pairs of density > -inf
    sorted descending, zeros after them; counts (S,) int32), as
    ``ref.candidate_keys_ref``."""
    if values.dim() != 3:
        raise ValueError(f"values: {values.dim()} dims, expected (S, N, M)")
    s, n, m = values.shape
    _check_pairs(n, m)
    _check_cuda(((values, "values", torch.float32, (s, n, m)),
                 (costs, "costs", torch.float32, (s, n)),
                 (eligible, "eligible", torch.bool, (s, n, m))))
    cap = key_capacity(n, m)
    keys = torch.empty((s, cap), dtype=torch.int64, device=values.device)
    counts = torch.empty((s,), dtype=torch.int32, device=values.device)
    if s == 0:
        return keys, counts
    code = _lib().budgeted_topk_keys_launch(
        values.data_ptr(), costs.data_ptr(), eligible.data_ptr(),
        keys.data_ptr(), counts.data_ptr(), s, n, m, raw_stream(values))
    raise_on_error(code, "budgeted_topk")
    count_launch("budgeted_topk")
    return keys, counts


def flgreedy_walk_kernel(keys: torch.Tensor, counts: torch.Tensor,
                         values: torch.Tensor, costs: torch.Tensor,
                         budgets: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P3's walk over ``budgeted_topk_keys_kernel``'s output (the
    utility's total over M): keys (S, cap) int64, counts (S,) int32,
    values (S, N, M) float32, costs (S, N), budgets (S, M) float32 ->
    (assign (S, N) int32, -1 = unselected; remaining (S, M) float32)."""
    if values.dim() != 3:
        raise ValueError(f"values: {values.dim()} dims, expected (S, N, M)")
    s, n, m = values.shape
    _check_pairs(n, m)
    cap = key_capacity(n, m)
    _check_cuda(((keys, "keys", torch.int64, (s, cap)),
                 (counts, "counts", torch.int32, (s,)),
                 (values, "values", torch.float32, (s, n, m)),
                 (costs, "costs", torch.float32, (s, n)),
                 (budgets, "budgets", torch.float32, (s, m))))
    assign = torch.empty((s, n), dtype=torch.int32, device=values.device)
    remaining = torch.empty((s, m), dtype=torch.float32,
                            device=values.device)
    if s == 0:
        return assign, remaining
    code = _walk()(keys.data_ptr(), counts.data_ptr(), values.data_ptr(),
                   costs.data_ptr(), budgets.data_ptr(), assign.data_ptr(),
                   remaining.data_ptr(), s, n, m, cap, rcp(m),
                   raw_stream(values))
    raise_on_error(code, "flgreedy_walk")
    count_launch("flgreedy_walk")
    return assign, remaining
