"""Plain PyTorch version of the budgeted_topk kernels: the P2 density
table, its (density desc, flat index desc) order, the P2 budget walk and
the P3 (sqrt utility) walk.

The pick order is a strict total order, density descending with ties
toward the larger flat (client * M + ES) index, so "the" sorted list is
unique and every tiling of the sort gives the same budget walk.
``density_sort_ref`` sorts one segment per client tile, the layout of the
reference's Pallas kernel bit for bit (a tile of N clients gives the
reference oracle's single segment, padded). ``greedy_walk`` is the
reference's walk over those segments: each segment exposes its first
still-feasible head, ``merge_heads`` takes the best head across segments,
and the budget and assignment advance, one pick per iteration. Both
walks take the reference's shard hooks (``merge``, ``base``,
``local_clients``): a client shard walks its own segments and merges
each pick across shards (``repro_torch.mesh.select``).

The walks are batched over seeds with a per-seed ``live`` flag and read
it back once per iteration (``live.any()``, a host sync on a CUDA
tensor); the P2 walk reads once more to cut its rows' prefix.
``WALK_SYNCS`` counts them. ``budgeted_topk_ref`` composes the
sort and the P2 walk into the function the CUDA kernel computes;
``candidate_keys_ref`` is the kernel's sort alone (every eligible pair of
a seed as one sorted list of 64-bit keys), and ``flgreedy_walk`` with
``flgreedy_topk_ref`` is P3's walk, the reference's
``ops.py::flgreedy_walk`` and ``flgreedy_topk``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.fmath import rcp, sqrt_rn

DEFAULT_TILE = 128

WALK_SYNCS: Dict[str, int] = {"greedy_walk": 0, "flgreedy_walk": 0,
                              "sharded_walk": 0}


def pair_density(values: torch.Tensor, costs: torch.Tensor,
                 eligible: torch.Tensor) -> torch.Tensor:
    """(..., N, M) value densities, -inf where ineligible."""
    dens = values / torch.clamp(costs[..., None], min=1e-12)
    return torch.where(eligible, dens, torch.full_like(dens, -torch.inf))


def sort_desc(d: torch.Tensor, ix: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort the last axis by (d desc, ix desc) with one sort over a
    composite int64 key: the float's order-preserving integer image in
    the high word, ``ix + 1`` in the low word."""
    d = d + 0.0                                   # -0.0 sorts as +0.0
    b = d.view(torch.int32).to(torch.int64)
    key = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    comp = key * (1 << 32) + (ix.to(torch.int64) + 1)
    comp, order = torch.sort(comp, dim=-1, descending=True)
    return torch.gather(d, -1, order), ((comp & 0xFFFFFFFF) - 1).to(
        torch.int32)


def density_sort_ref(values: torch.Tensor, costs: torch.Tensor,
                     eligible: torch.Tensor, tile: int = DEFAULT_TILE
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """values (S, N, M), costs (S, N), eligible (S, N, M) ->
    (densities, flat indices), each (S, num_tiles, P), every row sorted;
    P = next power of two >= tile * M, pads (-inf, -1)."""
    s, n, m = values.shape
    nt = -(-n // tile)
    p2 = 1 << (tile * m - 1).bit_length()
    pad = nt * tile - n
    dens = pair_density(values, costs, eligible)
    if pad:
        dens = torch.cat([dens, dens.new_full((s, pad, m), -torch.inf)], 1)
    d = dens.reshape(s, nt, tile * m)
    ix = torch.arange(nt * tile * m, dtype=torch.int32,
                      device=values.device).reshape(1, nt, tile * m)
    ix = ix.expand(s, nt, tile * m)
    if p2 > tile * m:
        extra = p2 - tile * m
        d = torch.cat([d, d.new_full((s, nt, extra), -torch.inf)], -1)
        ix = torch.cat([ix, ix.new_full((s, nt, extra), -1)], -1)
    return sort_desc(d, ix)


class Segments(NamedTuple):
    """Sorted candidate segments, (S, nseg, P) each: density (pads
    -inf), the *global* flat candidate index ``(base + row) * M + es``,
    the *local* client row, the ES column, and the candidate's cost and
    value carried per column (the reference's ``Segments``: a client
    shard's segments merge heads with other shards' without
    renumbering, and its walk indexes its own rows)."""
    density: torch.Tensor
    flat: torch.Tensor
    loc: torch.Tensor
    es: torch.Tensor
    cost: torch.Tensor
    value: torch.Tensor


def build_segments(values: torch.Tensor, costs: torch.Tensor,
                   eligible: torch.Tensor, tile: int = DEFAULT_TILE,
                   base: int = 0, sort=None) -> Segments:
    """``Segments`` of a (S, n, M) block whose rows are the global
    clients ``base .. base+n``; ``sort`` is the tile sort
    (``density_sort_ref`` unless given: ``ops`` routes it by device)."""
    s, n, m = values.shape
    d_s, i_s = (sort or density_sort_ref)(values, costs, eligible, tile)
    flat = torch.clamp(i_s.to(torch.int64), 0, n * m - 1)  # pads: d=-inf
    loc, es = flat // m, flat % m
    shape = flat.shape
    cost = torch.gather(costs, 1, loc.reshape(s, -1)).reshape(shape)
    value = torch.gather(values.reshape(s, -1), 1,
                         flat.reshape(s, -1)).reshape(shape)
    return Segments(density=d_s, flat=flat + int(base) * m, loc=loc, es=es,
                    cost=cost, value=value)


def merge_heads(head_d: torch.Tensor, head_i: torch.Tensor, aux=()):
    """Best head per seed over the last axis: max density, ties toward
    the larger flat index; each ``aux`` stream is read at the picked
    flat index. Returns (ok, pick, aux), each (S,). A sharded walk
    substitutes ``mesh.select.merge_over_shards``, which merges in two
    levels to the same pick (max is associative, flats are unique)."""
    dmax = head_d.max(dim=-1).values
    ok = dmax > -torch.inf
    pick = torch.where(head_d == dmax[..., None], head_i,
                       torch.full_like(head_i, -1)).max(dim=-1).values
    pick = torch.clamp(pick, min=0)
    out = tuple(torch.where(head_i == pick[..., None], a,
                            torch.full_like(a, -torch.inf)
                            ).max(dim=-1).values for a in aux)
    return ok, pick, out


def _apply_pick(assign, remaining, act, pick, cost, m: int, base: int):
    """A pick of the global flat index ``pick`` (S,): the owner of its
    client row writes the assignment, every walker spends the budget."""
    rows = torch.arange(assign.shape[0], device=assign.device)
    gi, j = pick // m, pick % m
    n_loc = assign.shape[1]
    owns = act & (gi >= base) & (gi < base + n_loc)
    li = torch.clamp(gi - base, 0, n_loc - 1)
    assign[rows, li] = torch.where(owns, j, assign[rows, li])
    remaining[rows, j] = torch.where(act, remaining[rows, j] + (-cost),
                                     remaining[rows, j])


def greedy_walk(segs: Segments, budgets: torch.Tensor, *, num_es: int,
                num_clients: int, local_clients: int = 0, base: int = 0,
                merge=merge_heads, counter: str = "greedy_walk"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The P2 density-greedy budget walk over sorted ``Segments``.
    budgets (S, M) float32. Returns (assign (S, n_loc) int32, remaining).

    With the defaults it is the dense walk. A client shard passes its
    own segments, ``local_clients`` rows starting at global ``base`` and
    a cross-shard ``merge``: it then returns its rows of the dense
    assignment, and every shard the same budgets (the reference's
    ``ops.greedy_walk`` hooks). On a CUDA tensor it syncs with the
    host once to cut the rows' prefix and once a pick to read ``live``
    back; ``WALK_SYNCS[counter]`` counts both."""
    m, n = num_es, num_clients
    n_loc = local_clients or n
    s = segs.density.shape[0]
    dev = segs.density.device
    assign = torch.full((s, n_loc), -1, dtype=torch.int64, device=dev)
    remaining = budgets.to(torch.float32).clone()
    live = torch.ones(s, dtype=torch.bool, device=dev)
    # rows are sorted, so no entry past a row's last positive density can
    # be picked: walk the shortest prefix holding every row's positives
    # (exact; one host read)
    last = (segs.density > 0.0).flatten(0, -2).any(dim=0).nonzero()
    k = int(last[-1]) + 1 if last.numel() else 1
    if dev.type == "cuda":
        WALK_SYNCS[counter] += 1
    segs = Segments(*(f[..., :k] for f in segs))
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
        ok, pick, (cost,) = merge(head(segs.density, -torch.inf),
                                  head(segs.flat, -1),
                                  (head(segs.cost, -torch.inf),))
        act = ok & live
        _apply_pick(assign, remaining, act, pick, cost, m, base)
        live = act
        WALK_SYNCS[counter] += 1
        if not bool(live.any()):
            break
    return assign.to(torch.int32), remaining


def budgeted_topk_ref(values: torch.Tensor, costs: torch.Tensor,
                      budgets: torch.Tensor, eligible: torch.Tensor,
                      tile: int = DEFAULT_TILE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """values (S, N, M), costs (S, N), budgets (S, M), eligible (S, N, M)
    -> (assign (S, N) int32, -1 = unselected; remaining (S, M) float32):
    the tile-sorted segments and the walk over them."""
    s, n, m = values.shape
    segs = build_segments(values, costs, eligible, tile)
    return greedy_walk(segs, budgets, num_es=m, num_clients=n)


def order_bits(d: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) that orders as the floats do (after
    ``+ 0.0``, so -0.0 and +0.0 share one image); -inf maps above 0."""
    b = (d + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)


def candidate_keys_ref(values: torch.Tensor, costs: torch.Tensor,
                       eligible: torch.Tensor, capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's sort without its walk: every pair of density > -inf
    (eligible, not NaN) as the key ``order_bits(density) << 32 | client
    << 14 | es``, each seed's keys sorted descending into ``capacity``
    slots, zeros after them. Returns (keys (S, capacity) int64, counts
    (S,) int32)."""
    s, n, m = values.shape
    dens = pair_density(values, costs, eligible).reshape(s, n * m)
    keep = dens > -torch.inf
    q = torch.arange(n * m, device=values.device)
    low = (q // m) * (1 << 14) + q % m
    # sorted as signed keys with the top bit flipped (unsigned order),
    # flipped back after; a dropped pair is key 0, i.e. int64's minimum
    low = torch.where(keep, low, torch.zeros_like(low))
    top = torch.where(keep, order_bits(dens) - (1 << 31),
                      torch.full_like(low, -(1 << 31)))
    keys = torch.sort(top * (1 << 32) + low, dim=-1,
                      descending=True).values ^ torch.iinfo(torch.int64).min
    out = keys.new_zeros((s, capacity))
    out[:, :n * m] = keys
    return out, keep.sum(dim=-1).to(torch.int32)


def flgreedy_gains(total: torch.Tensor, v: torch.Tensor, rcp_m: float
                   ) -> torch.Tensor:
    """``util(total + v) - util(total)`` with ``util(x) = sqrt(max(x, 0)
    / M)``; the division by the constant M is XLA's reciprocal multiply
    (R5), the roots correctly rounded."""
    util = lambda x: sqrt_rn(torch.clamp(x, min=0.0) * rcp_m)
    return util(total + v) - util(total)


def flgreedy_walk(segs: Segments, budgets: torch.Tensor, *, num_es: int,
                  num_clients: int, m_div: float, local_clients: int = 0,
                  base: int = 0, merge=merge_heads,
                  counter: str = "flgreedy_walk"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The P3 cost-benefit walk (Eq. 19 sqrt utility) over ``Segments``:
    gains depend on the running total, so every pick rescores every
    eligible candidate, ``gain / max(cost, 1e-12)``, and takes the best
    (ties toward the larger flat index) while its gain exceeds 1e-15.
    budgets (S, M) float32. Returns (assign (S, n_loc) int32,
    remaining). The shard hooks are ``greedy_walk``'s: ``merge`` reduces
    the whole rescored stream, its aux the picked value and cost."""
    m, n = num_es, num_clients
    n_loc = local_clients or n
    s = segs.density.shape[0]
    dev = segs.density.device
    flat = segs.flat.reshape(s, -1)
    loc, es = segs.loc.reshape(s, -1), segs.es.reshape(s, -1)
    v, c = segs.value.reshape(s, -1), segs.cost.reshape(s, -1)
    cand = (segs.density.reshape(s, -1) > -torch.inf) & (c > 0)
    rcp_m = rcp(m_div)
    assign = torch.full((s, n_loc), -1, dtype=torch.int64, device=dev)
    remaining = budgets.to(torch.float32).clone()
    total = torch.zeros(s, dtype=torch.float32, device=dev)
    live = torch.ones(s, dtype=torch.bool, device=dev)
    for _ in range(n):
        gains = flgreedy_gains(total[:, None], v, rcp_m)
        feas = (cand & (torch.gather(assign, 1, loc) < 0)
                & (c <= torch.gather(remaining, 1, es) + 1e-12))
        r = torch.where(feas, gains / torch.clamp(c, min=1e-12),
                        torch.full_like(gains, -torch.inf))
        ok, pick, (pv, pc) = merge(r, flat, (v, c))
        g = flgreedy_gains(total, pv, rcp_m)
        act = ok & (g > 1e-15) & live
        _apply_pick(assign, remaining, act, pick, pc, m, base)
        total = torch.where(act, total + pv, total)
        live = act
        WALK_SYNCS[counter] += 1
        if not bool(live.any()):
            break
    return assign.to(torch.int32), remaining


def flgreedy_topk_ref(values: torch.Tensor, costs: torch.Tensor,
                      budgets: torch.Tensor, eligible: torch.Tensor,
                      tile: int = DEFAULT_TILE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P3 over the tile-sorted segments, the utility's total over M:
    values (S, N, M), costs (S, N), budgets (S, M), eligible (S, N, M)
    -> (assign (S, N) int32, remaining (S, M) float32)."""
    s, n, m = values.shape
    segs = build_segments(values, costs, eligible, tile)
    return flgreedy_walk(segs, budgets, num_es=m, num_clients=n,
                         m_div=float(m))
