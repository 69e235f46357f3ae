"""Plain PyTorch versions for the budgeted_topk kernel: the P2 density
table and its (density desc, flat index desc) order.

The pick order is a strict total order, density descending with ties
toward the larger flat (client * M + ES) index, so "the" sorted list is
unique and every tiling of the sort gives the same budget walk.
``density_sort_ref`` is the plain version of the CUDA kernel: one
sorted segment per client tile, the layout of the reference's Pallas
kernel bit for bit (a tile of N clients gives the reference oracle's
single segment, padded).
"""
from __future__ import annotations

from typing import Tuple

import torch

DEFAULT_TILE = 128


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
