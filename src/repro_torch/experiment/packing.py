"""Packing a round's assignment into fixed-capacity (ES, slot) arrays.

Client c assigned to ES j lands in slot ``rank of c among the clients
assigned to j`` (ascending client index), as the reference's
``pack_assignment``. Only the valid entries are written (no scratch cell
that colliding writes would share).

``pack_assignment_sharded`` packs a client shard's rows at their global
slots (the shard's own per-ES rank plus the exclusive prefix of earlier
shards' counts) and exchanges the blocks over the shard's "clients"
group: every rank gets the dense ``pack_assignment`` bit for bit, with
global client ids (the reference's ``pack_assignment_sharded``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.policies.solvers import feasible_cohort_bound


def slot_capacity(budget: float, min_cost: float, num_clients: int) -> int:
    """Static slot count: the budget bound at the smallest cost."""
    return feasible_cohort_bound(budget, min_cost, num_clients)


def es_counts(assign: torch.Tensor, num_es: int) -> torch.Tensor:
    """(S, M) number of clients assigned to each ES."""
    onehot = assign.long()[..., None] == torch.arange(
        num_es, device=assign.device)
    return onehot.sum(dim=1)


def pack_assignment(assign: torch.Tensor, outcomes: torch.Tensor,
                    latency: torch.Tensor, num_es: int, slots: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """assign (S, N) int, -1 = unselected; outcomes/latency (S, N, M).
    Returns (client_idx int32, valid, arrived, tau float32), each
    (S, M, slots); unfilled slots hold (0, 0, 0, +inf)."""
    s, n = assign.shape
    dev = assign.device
    a = assign.long()
    onehot = a[..., None] == torch.arange(num_es, device=dev)
    rank = torch.cumsum(onehot.long(), dim=1) - 1              # (S, N, M)
    j = torch.clamp(a, 0, num_es - 1)
    slot = torch.gather(rank, 2, j[..., None])[..., 0]
    ok = (a >= 0) & (slot < slots)
    si, ci = ok.nonzero(as_tuple=True)
    rows, cols = j[si, ci], slot[si, ci]
    client_idx = torch.zeros((s, num_es, slots), dtype=torch.int32,
                             device=dev)
    valid = torch.zeros((s, num_es, slots), dtype=torch.float32, device=dev)
    arrived = torch.zeros_like(valid)
    tau = torch.full_like(valid, torch.inf)
    client_idx.index_put_((si, rows, cols), ci.to(torch.int32))
    valid.index_put_((si, rows, cols), torch.ones_like(ci,
                                                       dtype=torch.float32))
    arrived.index_put_((si, rows, cols),
                       outcomes[si, ci, rows].to(torch.float32))
    tau.index_put_((si, rows, cols), latency[si, ci, rows].to(torch.float32))
    return client_idx, valid, arrived, tau


def pack_capacity(counts: torch.Tensor, slots: Optional[int]) -> int:
    """The slot capacity from the round's (S, M) per-ES counts: the
    largest cohort, or the pinned ``slots`` (a round over it raises), as
    ``fed.batched.train_round`` decides it."""
    peak = max(int(counts.max()), 1) if counts.numel() else 1
    if slots is None:
        return peak
    if peak > slots:
        raise ValueError(
            f"a round assigned {peak} clients to one ES but slots_per_es="
            f"{slots}; raise slots_per_es or leave it None")
    return slots


def pack_rows(assign: torch.Tensor, outcomes: torch.Tensor,
              latency: torch.Tensor, num_es: int, slots: int,
              prefix: torch.Tensor, base: int) -> torch.Tensor:
    """One shard's part of the pack: its rows ``base .. base+n_local``
    (assign (S, n_local), outcomes/latency (S, n_local, M)) at global
    slot ``prefix[s, j] + (rank among the shard's clients of j)``, as an
    (S, M, slots, 4) float64 block of (client_idx, valid, arrived, tau);
    slots it does not fill hold (0, 0, 0, +inf). float64 holds each
    field exactly."""
    s, n = assign.shape
    dev = assign.device
    a = assign.long()
    onehot = a[..., None] == torch.arange(num_es, device=dev)
    rank = torch.cumsum(onehot.long(), dim=1) - 1              # (S, n, M)
    j = torch.clamp(a, 0, num_es - 1)
    slot = (torch.gather(rank, 2, j[..., None])[..., 0]
            + torch.gather(prefix.long(), 1, j))
    ok = (a >= 0) & (slot < slots)
    si, ci = ok.nonzero(as_tuple=True)
    rows, cols = j[si, ci], slot[si, ci]
    out = torch.zeros((s, num_es, slots, 4), dtype=torch.float64,
                      device=dev)
    out[..., 3] = torch.inf
    out[si, rows, cols] = torch.stack(
        [(ci + base).double(), torch.ones_like(ci, dtype=torch.float64),
         outcomes[si, ci, rows].double(), latency[si, ci, rows].double()],
        dim=-1)
    return out


def pack_assignment_sharded(assign: torch.Tensor, outcomes: torch.Tensor,
                            latency: torch.Tensor, num_es: int,
                            slots: Optional[int], group, base: int
                            ) -> Tuple[torch.Tensor, ...]:
    """A client shard's rows (assign (S, n_local), outcomes/latency (S,
    n_local, M), global rows from ``base``) -> the dense
    ``pack_assignment`` (client_idx int32 with global ids, valid,
    arrived, tau), each (S, M, slots), on every rank of ``group``. The
    capacity is ``pack_capacity`` of the global counts. Two collectives:
    the per-ES counts, then the packed blocks."""
    from repro_torch.launch.mesh import all_gather

    counts = all_gather(es_counts(assign, num_es), group, tag="pack")
    r = torch.distributed.get_rank(group)
    cap = pack_capacity(counts.sum(dim=0), slots)
    block = pack_rows(assign, outcomes, latency, num_es, cap,
                      counts[:r].sum(dim=0), base)
    return merge_packs(all_gather(block, group, tag="pack"))


def merge_packs(blocks: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Every shard's ``pack_rows`` block (k, S, M, slots, 4) -> the dense
    (client_idx int32, valid, arrived, tau float32), each (S, M, slots):
    a slot's values from the one shard that filled it."""
    owner = blocks[..., 1].argmax(dim=0, keepdim=True)       # valid
    got = torch.take_along_dim(blocks, owner[..., None], dim=0)[0]
    return (got[..., 0].to(torch.int32), got[..., 1].float(),
            got[..., 2].float(), got[..., 3].float())
