"""Launch wrappers of the selection kernels: the one-pass P2 kernel
(``csrc/budgeted_topk.cu``), its keys-only launch (density and sort, for
P3), P3's walk over those keys (``csrc/flgreedy_walk.cu``), and past
``MAX_PAIRS`` the TPU kernel's own tile grid (``density_sort_tiles``,
same source) with P2's walk over its segments (``csrc/segment_walk.cu``).
Each checks, allocates, launches, counts.

The one-pass kernel keeps a seed's candidate pairs in shared memory, so
it and the launches built on it take at most ``MAX_PAIRS`` pairs (N * M)
a seed; their wrappers refuse more before they build or launch
anything. The tile grid sorts one client tile a block (tile * M <=
``MAX_PAIRS``), so it takes any N; the segment walk holds a head a
segment and a bit a client in shared memory, at most ``MAX_SMEM`` bytes.
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
MAX_SMEM = 232448      # shared memory a block can use on the H100

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
def _tiles():
    fn = _build.load("budgeted_topk").density_sort_tiles_launch
    fn.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _segment_walk():
    fn = _build.load("segment_walk").segment_walk_launch
    fn.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


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


def tile_for(m: int) -> int:
    """The client tile of the tile grid at M ES: the largest power of two
    with tile * M <= ``MAX_PAIRS`` (512 at M = 32, 256 at M = 64). The
    walk's result does not depend on it: the pick order is strict."""
    if m < 1 or m > MAX_PAIRS:
        raise ValueError(f"density_sort_tiles: M = {m} ES, expected 1 .. "
                         f"{MAX_PAIRS}")
    return 1 << (MAX_PAIRS // m).bit_length() - 1


def tile_shape(n: int, m: int, tile: int) -> Tuple[int, int]:
    """(num_tiles, P) of the tile grid: P the next power of two >=
    tile * M."""
    return -(-n // tile), 1 << (tile * m - 1).bit_length()


def walk_smem(n: int, m: int, nseg: int) -> int:
    """Shared memory of the segment walk's block: four words a segment
    head, the M budgets, a bit a client."""
    return nseg * 16 + m * 4 + (n + 31) // 32 * 4


def density_sort_tiles_kernel(values: torch.Tensor, costs: torch.Tensor,
                              eligible: torch.Tensor, tile: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """values (S, N, M) float32, costs (S, N) float32, eligible (S, N, M)
    bool on one CUDA device -> (density (S, num_tiles, P) float32, flat
    index (S, num_tiles, P) int32), each row one client tile sorted by
    (density desc, flat desc), pads (-inf, -1): ``ref.density_sort_ref``
    bit for bit. tile * M <= ``MAX_PAIRS``."""
    if values.dim() != 3:
        raise ValueError(f"values: {values.dim()} dims, expected (S, N, M)")
    s, n, m = values.shape
    if tile < 1 or tile * m > MAX_PAIRS:
        raise ValueError(f"density_sort_tiles: tile * M = {tile} * {m}; a "
                         f"block sorts at most {MAX_PAIRS} pairs")
    nt, p = tile_shape(n, m, tile)
    if (nt * tile + 1) * m >= 2 ** 31:
        raise ValueError(f"density_sort_tiles: {nt * tile} x {m} pairs a "
                         "seed overflow the int32 flat index")
    _check_cuda(((values, "values", torch.float32, (s, n, m)),
                 (costs, "costs", torch.float32, (s, n)),
                 (eligible, "eligible", torch.bool, (s, n, m))))
    dens = torch.empty((s, nt, p), dtype=torch.float32, device=values.device)
    flat = torch.empty((s, nt, p), dtype=torch.int32, device=values.device)
    if s == 0 or nt == 0:
        return dens, flat
    code = _tiles()(values.data_ptr(), costs.data_ptr(), eligible.data_ptr(),
                    dens.data_ptr(), flat.data_ptr(), s, n, m, tile,
                    raw_stream(values))
    raise_on_error(code, "density_sort_tiles")
    count_launch("density_sort_tiles")
    return dens, flat


def segment_walk_kernel(density: torch.Tensor, flat: torch.Tensor,
                        costs: torch.Tensor, budgets: torch.Tensor,
                        num_es: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """P2's walk over sorted segments: density (S, nseg, P) float32 and
    flat (S, nseg, P) int32 as ``density_sort_tiles_kernel`` gives them,
    costs (S, N) float32, budgets (S, M) float32 -> (assign (S, N) int32,
    -1 = unselected; remaining (S, M) float32), ``ref.greedy_walk`` over
    the same segments bit for bit."""
    if density.dim() != 3:
        raise ValueError(f"density: {density.dim()} dims, expected "
                         "(S, nseg, P)")
    s, nseg, p = density.shape
    n, m = costs.shape[-1], int(num_es)
    if walk_smem(n, m, nseg) > MAX_SMEM:
        raise ValueError(
            f"segment_walk: {nseg} segments and {n} clients need "
            f"{walk_smem(n, m, nseg)} bytes of shared memory, over the "
            f"block's {MAX_SMEM}")
    _check_cuda(((density, "density", torch.float32, (s, nseg, p)),
                 (flat, "flat", torch.int32, (s, nseg, p)),
                 (costs, "costs", torch.float32, (s, n)),
                 (budgets, "budgets", torch.float32, (s, m))))
    assign = torch.empty((s, n), dtype=torch.int32, device=density.device)
    remaining = torch.empty((s, m), dtype=torch.float32,
                            device=density.device)
    if s == 0:
        return assign, remaining
    code = _segment_walk()(density.data_ptr(), flat.data_ptr(),
                           costs.data_ptr(), budgets.data_ptr(),
                           assign.data_ptr(), remaining.data_ptr(), s, n, m,
                           nseg, p, raw_stream(density))
    raise_on_error(code, "segment_walk")
    count_launch("segment_walk")
    return assign, remaining
