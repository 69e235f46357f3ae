"""Budgeted top-k selection (P2 density greedy) over sorted candidates.

The density table is computed and sorted once per round, one sorted
segment per client tile (the CUDA density-sort kernel on a CUDA device,
its plain version on the CPU). The budget walk then takes one greedy
pick per iteration: each segment exposes its first still-feasible head,
``merge_heads`` takes the best head across segments, and the budget and
assignment advance. Because the pick order is a strict total order and
feasibility only shrinks, the per-tile segments merge to exactly the
global greedy sequence of the reference's ``greedy_assign``.

The walk is batched over seeds with a per-seed ``live`` flag and costs
one host sync per iteration (``live.any()``); ``WALK_SYNCS`` counts them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels.budgeted_topk.ref import (DEFAULT_TILE,
                                                   density_sort_ref)
from repro_torch.kernels.common import on_cuda

WALK_SYNCS: Dict[str, int] = {"greedy_walk": 0}


def sorted_candidates(values: torch.Tensor, costs: torch.Tensor,
                      eligible: torch.Tensor, tile: int = DEFAULT_TILE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(density, flat index) segments (S, num_tiles, P), each row sorted
    (density desc, index desc); padding rides as density -inf."""
    if not on_cuda(values, costs, eligible):
        return density_sort_ref(values, costs, eligible, tile)
    from repro_torch.kernels.budgeted_topk.kernel import density_sort_kernel
    return density_sort_kernel(values.contiguous(), costs.contiguous(),
                               eligible.contiguous(), tile)


class Segments(NamedTuple):
    """Sorted candidate segments, (S, nseg, P) each: density (pads
    -inf), flat candidate index, client row, ES column, and the
    candidate's cost and value carried per column."""
    density: torch.Tensor
    flat: torch.Tensor
    loc: torch.Tensor
    es: torch.Tensor
    cost: torch.Tensor
    value: torch.Tensor


def build_segments(values: torch.Tensor, costs: torch.Tensor,
                   eligible: torch.Tensor, tile: int = DEFAULT_TILE
                   ) -> Segments:
    s, n, m = values.shape
    d_s, i_s = sorted_candidates(values, costs, eligible, tile)
    flat = torch.clamp(i_s.to(torch.int64), 0, n * m - 1)  # pads: d=-inf
    loc, es = flat // m, flat % m
    shape = flat.shape
    cost = torch.gather(costs, 1, loc.reshape(s, -1)).reshape(shape)
    value = torch.gather(values.reshape(s, -1), 1,
                         flat.reshape(s, -1)).reshape(shape)
    return Segments(density=d_s, flat=flat, loc=loc, es=es, cost=cost,
                    value=value)


def merge_heads(head_d: torch.Tensor, head_i: torch.Tensor,
                head_c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best head per seed over the segment axis: max density, ties
    toward the larger flat index. Returns (ok, pick, cost), each (S,)."""
    dmax = head_d.max(dim=-1).values
    ok = dmax > -torch.inf
    pick = torch.where(head_d == dmax[:, None], head_i,
                       torch.full_like(head_i, -1)).max(dim=-1).values
    pick = torch.clamp(pick, min=0)
    cost = torch.where(head_i == pick[:, None], head_c,
                       torch.full_like(head_c, -torch.inf)
                       ).max(dim=-1).values
    return ok, pick, cost


def greedy_walk(segs: Segments, budgets: torch.Tensor, *, num_es: int,
                num_clients: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The P2 density-greedy budget walk over sorted ``Segments``.
    budgets (S, M) float32. Returns (assign (S, N) int32, remaining)."""
    m, n = num_es, num_clients
    s = segs.density.shape[0]
    dev = segs.density.device
    rows = torch.arange(s, device=dev)
    assign = torch.full((s, n), -1, dtype=torch.int64, device=dev)
    remaining = budgets.to(torch.float32).clone()
    live = torch.ones(s, dtype=torch.bool, device=dev)
    positive = segs.density > 0.0
    loc = segs.loc.reshape(s, -1)
    es = segs.es.reshape(s, -1)
    shape = segs.density.shape
    for _ in range(n):
        free = torch.gather(assign, 1, loc).reshape(shape) < 0
        room = torch.gather(remaining, 1, es).reshape(shape) + 1e-12
        feas = positive & free & (segs.cost <= room)
        hit = feas.any(dim=-1)
        first = feas.to(torch.uint8).argmax(dim=-1, keepdim=True)
        head = lambda a, fill: torch.where(
            hit, torch.gather(a, -1, first).squeeze(-1),
            torch.full_like(hit, fill, dtype=a.dtype))
        ok, pick, cost = merge_heads(head(segs.density, -torch.inf),
                                     head(segs.flat, -1),
                                     head(segs.cost, -torch.inf))
        act = ok & live
        gi, j = pick // m, pick % m
        assign[rows, gi] = torch.where(act, j, assign[rows, gi])
        remaining[rows, j] = torch.where(act, remaining[rows, j] + (-cost),
                                         remaining[rows, j])
        live = act
        WALK_SYNCS["greedy_walk"] += 1
        if not bool(live.any()):
            break
    return assign.to(torch.int32), remaining


def budgeted_topk(values: torch.Tensor, costs: torch.Tensor,
                  budgets: torch.Tensor, eligible: torch.Tensor,
                  tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Density greedy for P2. values (S, N, M), costs (S, N), budgets
    (S, M) or (M,), eligible (S, N, M) bool -> assign (S, N) int32
    (-1 = unselected)."""
    s, n, m = values.shape
    budgets = torch.as_tensor(budgets, dtype=torch.float32,
                              device=values.device).expand(s, m)
    segs = build_segments(values, costs, eligible, tile)
    assign, _ = greedy_walk(segs, budgets, num_es=m, num_clients=n)
    return assign
