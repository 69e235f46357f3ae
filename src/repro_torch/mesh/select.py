"""Hierarchical budgeted selection over a client-sharded candidate table.

The dense P2/P3 solvers walk one sorted candidate layout a round
(``kernels.budgeted_topk``). A client shard can sort only its own rows,
so selection becomes two-level: each shard finds its segments' heads,
reduces them to one champion, and an ``all_gather`` of the champions
over the shard's "clients" group gives the global pick. Max is exactly
associative and flat candidate indices are globally unique, so the merge
topology is invisible: the pick sequence, and so the assignment, is
bitwise the dense ``greedy_assign``/``flgreedy_assign``.

Two entry points share the walk of ``kernels.budgeted_topk.ref``:

* ``shard_assign``, the distributed form: a rank's (S, n_local, M)
  tables, one merge through its clients group a pick (every rank of the
  group runs the same number of picks: the merged ``ok`` is the same on
  each). Its segments come from the tile sort (the ``density_sort_tiles``
  kernel on CUDA); the walk is tensor ops with one host sync a pick,
  counted in ``WALK_SYNCS["sharded_walk"]``, as the reference's walk is
  XLA's ``while_loop`` here too;
* ``hier_greedy_assign``/``hier_flgreedy_assign``, the single-process
  emulation: every shard's segments stacked into one walk with the
  default merge, the same reduction tree, bitwise the dense solvers at
  any shard count.

A seed row's merges ride its own group, so seed rows need no lockstep
(the reference's ``sync_axes=("seed",)`` exists because XLA's
collectives are mesh-wide).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.budgeted_topk import ref
from repro_torch.kernels.budgeted_topk.kernel import tile_for
from repro_torch.kernels.budgeted_topk.ops import (DEFAULT_TILE,
                                                   build_segments)
from repro_torch.kernels.budgeted_topk.ref import (Segments, flgreedy_walk,
                                                   greedy_walk)
from repro_torch.launch.mesh import all_gather


def merge_over_shards(group):
    """The cross-shard head merge over ``group``: reduce locally to one
    champion (density, flat, aux...) a seed, ``all_gather`` the
    champions, reduce again. Ties break toward the larger *global* flat
    index at both levels, so the two-level reduction equals the dense
    single-level merge exactly. One collective a pick."""

    def merge(head_d, head_i, aux=()):
        ok, li, laux = ref.merge_heads(head_d, head_i, aux)
        ld = head_d.max(dim=-1).values
        li = torch.where(ok, li, torch.full_like(li, -1))
        # one float64 gather a pick: densities, costs and values are
        # float32 and flat indices < 2^31, all exact in float64
        local = torch.stack([ld.double(), li.double()]
                            + [a.double() for a in laux], dim=-1)
        g = all_gather(local, group, tag="walk")          # (k, S, 2 + A)
        g = g.movedim(0, -1)                               # (S, 2 + A, k)
        gok, pick, gaux = ref.merge_heads(
            g[:, 0].float(), g[:, 1].long(),
            tuple(g[:, 2 + i].float() for i in range(len(aux))))
        return gok, pick, gaux

    return merge


def _segments(values, costs, eligible, base: int) -> Segments:
    # the tile grid's own tile on the card, the plain version's on the
    # CPU (a short row a tile there); the walk does not depend on it
    tile = tile_for(values.shape[-1]) if values.is_cuda else DEFAULT_TILE
    return build_segments(values, costs, eligible, tile, base)


def shard_assign(values: torch.Tensor, costs: torch.Tensor,
                 eligible: torch.Tensor, budgets: torch.Tensor, *, group,
                 num_clients: int, base: int, sqrt_utility: bool = False
                 ) -> torch.Tensor:
    """One shard's half of the hierarchical selection. values/eligible
    (S, n_local, M), costs (S, n_local): this rank's rows ``base ..
    base+n_local`` of the dense tables; budgets (S, M) or (M,), the
    same on every rank of ``group``. Returns the rank's (S, n_local)
    rows of the dense solver's assignment."""
    s, n_local, m = values.shape
    budgets = torch.as_tensor(budgets, dtype=torch.float32,
                              device=values.device).expand(s, m)
    segs = _segments(values, costs, eligible, base)
    merge = merge_over_shards(group)
    kw = dict(num_es=m, num_clients=num_clients, local_clients=n_local,
              base=base, merge=merge, counter="sharded_walk")
    if sqrt_utility:
        return flgreedy_walk(segs, budgets, m_div=float(m), **kw)[0]
    return greedy_walk(segs, budgets, **kw)[0]


# -- single-process emulation -------------------------------------------------


def shard_segments(values: torch.Tensor, costs: torch.Tensor,
                   eligible: torch.Tensor, num_shards: int,
                   tile: int = DEFAULT_TILE) -> Segments:
    """Each of ``num_shards`` client shards' sorted segments of a dense
    (S, N, M) table, stacked along the segment axis: what the shards
    build on their own rows, with global flat indices and global ``loc``
    rows (the emulation walks one global assignment). N must divide."""
    s, n, m = values.shape
    n_local = n // num_shards
    parts = [build_segments(values[:, i * n_local:(i + 1) * n_local],
                            costs[:, i * n_local:(i + 1) * n_local],
                            eligible[:, i * n_local:(i + 1) * n_local],
                            tile, i * n_local)
             for i in range(num_shards)]
    segs = Segments(*(torch.cat(f, dim=1) for f in zip(*parts)))
    return segs._replace(loc=segs.flat // m)


def _pad_clients(values, costs, eligible, num_shards: int):
    n = values.shape[1]
    pad = -(-n // num_shards) * num_shards - n
    if pad == 0:
        return values, costs, eligible, n
    # padded rows are ineligible: density -inf, never picked
    z = lambda a, fill: torch.cat(
        [a, a.new_full((a.shape[0], pad) + a.shape[2:], fill)], dim=1)
    return z(values, 0.0), z(costs, 1.0), z(eligible, False), n


def hier_greedy_assign(values: torch.Tensor, costs: torch.Tensor,
                       budgets: torch.Tensor, eligible: torch.Tensor,
                       num_shards: int = 1, tile: int = DEFAULT_TILE
                       ) -> torch.Tensor:
    """P2's density greedy over ``num_shards`` shards' segments: values
    (S, N, M), costs (S, N), budgets (S, M) or (M,), eligible (S, N, M)
    -> (S, N) int32, bitwise ``greedy_assign`` at any shard count. An N
    that does not divide is padded with ineligible rows (a real mesh
    pads the same way), cut off the result."""
    s, _, m = values.shape
    values, costs, eligible, n = _pad_clients(values, costs, eligible,
                                              num_shards)
    budgets = torch.as_tensor(budgets, dtype=torch.float32,
                              device=values.device).expand(s, m)
    segs = shard_segments(values, costs, eligible, num_shards, tile)
    assign, _ = greedy_walk(segs, budgets, num_es=m,
                            num_clients=values.shape[1])
    return assign[:, :n]


def hier_flgreedy_assign(values: torch.Tensor, costs: torch.Tensor,
                         budgets: torch.Tensor, eligible: torch.Tensor,
                         num_shards: int = 1, num_es: int = 0,
                         tile: int = DEFAULT_TILE) -> torch.Tensor:
    """P3's sqrt-utility cost-benefit greedy over the shards' segments,
    bitwise ``flgreedy_assign`` at any shard count."""
    s, _, m = values.shape
    values, costs, eligible, n = _pad_clients(values, costs, eligible,
                                              num_shards)
    budgets = torch.as_tensor(budgets, dtype=torch.float32,
                              device=values.device).expand(s, m)
    segs = shard_segments(values, costs, eligible, num_shards, tile)
    assign, _ = flgreedy_walk(segs, budgets, num_es=m,
                              num_clients=values.shape[1],
                              m_div=float(num_es or m))
    return assign[:, :n]
