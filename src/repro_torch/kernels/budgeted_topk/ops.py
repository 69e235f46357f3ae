"""Budgeted top-k selection (P2 density greedy, P3 cost-benefit greedy):
routing by device.

P2: a CUDA tensor of at most ``MAX_PAIRS`` (client, ES) pairs a seed
launches the one-pass kernel (``kernel.py``, ``csrc/budgeted_topk.cu``):
density, sort and budget walk for every seed in one launch, with no host
sync. Above it, the TPU kernel's own tile grid (``density_sort_tiles``:
one sorted segment a client tile) and P2's walk over those segments
(``segment_walk``, one block a seed), two launches and no host sync. A
CPU tensor takes the plain version (``ref.py``): the tile-sorted
segments and the reference's walk over them, one pick per iteration.
All give the reference's assignments (``greedy_assign``) and budgets
left (``greedy_walk``) bit for bit.

P3 (``flgreedy_topk``): on CUDA, B2's keys-only launch (density and sort)
and then P3's walk kernel (``csrc/flgreedy_walk.cu``), two launches for
every seed and no host sync, up to ``MAX_PAIRS`` pairs a seed (above it
the kernels raise: ROADMAP queue B); on the CPU the plain version. Both
give the reference's ``flgreedy_assign`` bit for bit.

``sorted_candidates`` and ``build_segments`` route the tile sort alike;
the sharded cohort engine (``repro_torch.mesh.select``) walks the
segments of its own rows with ``ref.greedy_walk``'s shard hooks.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.budgeted_topk import ref
from repro_torch.kernels.budgeted_topk.ref import (  # noqa: F401
    DEFAULT_TILE, WALK_SYNCS, Segments, budgeted_topk_ref,
    candidate_keys_ref, density_sort_ref, flgreedy_topk_ref, flgreedy_walk,
    greedy_walk, merge_heads)
from repro_torch.kernels.budgeted_topk.kernel import MAX_PAIRS
from repro_torch.kernels.common import on_cuda


def sorted_candidates(values: torch.Tensor, costs: torch.Tensor,
                      eligible: torch.Tensor, tile: int = DEFAULT_TILE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile sort, (S, num_tiles, P) densities and flat indices: the
    ``density_sort_tiles`` kernel on CUDA, ``density_sort_ref`` on the
    CPU."""
    if not on_cuda(values, costs, eligible):
        return density_sort_ref(values, costs, eligible, tile)
    from repro_torch.kernels.budgeted_topk.kernel import \
        density_sort_tiles_kernel
    return density_sort_tiles_kernel(values.contiguous(), costs.contiguous(),
                                     eligible.contiguous(), tile)


def build_segments(values: torch.Tensor, costs: torch.Tensor,
                   eligible: torch.Tensor, tile: int = DEFAULT_TILE,
                   base: int = 0) -> Segments:
    """``ref.build_segments`` over the routed tile sort."""
    return ref.build_segments(values, costs, eligible, tile, base,
                              sort=sorted_candidates)


def budgeted_topk_walk(values: torch.Tensor, costs: torch.Tensor,
                       budgets: torch.Tensor, eligible: torch.Tensor,
                       tile: int = DEFAULT_TILE
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density greedy for P2. values (S, N, M), costs (S, N), budgets
    (S, M) or (M,), eligible (S, N, M) bool -> (assign (S, N) int32,
    -1 = unselected; remaining (S, M) float32). ``tile`` shapes the plain
    version's segments only (the CUDA tile grid takes ``tile_for(M)``);
    the result does not depend on it."""
    s, n, m = values.shape
    budgets = torch.as_tensor(budgets, dtype=torch.float32,
                              device=values.device).expand(s, m)
    if not on_cuda(values, costs, eligible):
        return budgeted_topk_ref(values, costs, budgets, eligible, tile)
    from repro_torch.kernels.budgeted_topk import kernel as K
    values, costs = values.contiguous(), costs.contiguous()
    eligible, budgets = eligible.contiguous(), budgets.contiguous()
    if n * m <= MAX_PAIRS:
        return K.budgeted_topk_kernel(values, costs, budgets, eligible)
    dens, flat = K.density_sort_tiles_kernel(values, costs, eligible,
                                             K.tile_for(m))
    return K.segment_walk_kernel(dens, flat, costs, budgets, m)


def budgeted_topk(values: torch.Tensor, costs: torch.Tensor,
                  budgets: torch.Tensor, eligible: torch.Tensor,
                  tile: int = DEFAULT_TILE) -> torch.Tensor:
    """``budgeted_topk_walk``'s assignment alone: (S, N) int32."""
    return budgeted_topk_walk(values, costs, budgets, eligible, tile)[0]


def flgreedy_topk_walk(values: torch.Tensor, costs: torch.Tensor,
                       budgets: torch.Tensor, eligible: torch.Tensor,
                       tile: int = DEFAULT_TILE
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cost-benefit greedy for P3 (Eq. 19 sqrt utility, the total over
    M). values (S, N, M), costs (S, N), budgets (S, M) or (M,), eligible
    (S, N, M) bool -> (assign (S, N) int32, -1 = unselected; remaining
    (S, M) float32)."""
    s, n, m = values.shape
    budgets = torch.as_tensor(budgets, dtype=torch.float32,
                              device=values.device).expand(s, m)
    if not on_cuda(values, costs, eligible):
        return flgreedy_topk_ref(values, costs, budgets, eligible, tile)
    from repro_torch.kernels.budgeted_topk.kernel import (
        budgeted_topk_keys_kernel, flgreedy_walk_kernel)
    values, costs = values.contiguous(), costs.contiguous()
    keys, counts = budgeted_topk_keys_kernel(values, costs,
                                             eligible.contiguous())
    return flgreedy_walk_kernel(keys, counts, values, costs,
                                budgets.contiguous())


def flgreedy_topk(values: torch.Tensor, costs: torch.Tensor,
                  budgets: torch.Tensor, eligible: torch.Tensor,
                  tile: int = DEFAULT_TILE) -> torch.Tensor:
    """``flgreedy_topk_walk``'s assignment alone: (S, N) int32."""
    return flgreedy_topk_walk(values, costs, budgets, eligible, tile)[0]
