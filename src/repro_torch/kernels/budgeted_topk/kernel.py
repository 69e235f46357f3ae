"""Launch wrapper of the CUDA density sort (``csrc/density_sort.cu``):
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


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("density_sort").density_sort_launch
    fn.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def density_sort_kernel(values: torch.Tensor, costs: torch.Tensor,
                        eligible: torch.Tensor, tile: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """values (S, N, M) float32, costs (S, N) float32, eligible (S, N, M)
    bool, on one CUDA device -> (S, num_tiles, P) float32 densities and
    int32 flat indices, every row sorted (density desc, index desc)."""
    s, n, m = values.shape
    check(values, "values", torch.float32, (s, n, m))
    check(costs, "costs", torch.float32, (s, n))
    check(eligible, "eligible", torch.bool, (s, n, m))
    p2 = 1 << (tile * m - 1).bit_length()
    if p2 * 8 > 227 * 1024:
        raise ValueError(f"tile {tile} x {m} ES needs {p2 * 8} B of "
                         "shared memory; use a smaller tile")
    nt = -(-n // tile)
    out_d = torch.empty((s, nt, p2), dtype=torch.float32,
                        device=values.device)
    out_i = torch.empty((s, nt, p2), dtype=torch.int32,
                        device=values.device)
    code = _fn()(values.data_ptr(), costs.data_ptr(), eligible.data_ptr(),
                 out_d.data_ptr(), out_i.data_ptr(), s, n, m, tile, p2,
                 torch.cuda.current_stream(values.device).cuda_stream)
    raise_on_error(code, "budgeted_topk")
    count_launch("budgeted_topk")
    return out_d, out_i
