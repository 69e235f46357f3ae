"""Packing a round's assignment into fixed-capacity (ES, slot) arrays.

Client c assigned to ES j lands in slot ``rank of c among the clients
assigned to j`` (ascending client index), as the reference's
``pack_assignment``. Only the valid entries are written (no scratch cell
that colliding writes would share).
"""
from __future__ import annotations

from typing import Tuple

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
