"""Plain PyTorch version of Random's scan (the reference's
``policies/solvers.py::random_assign``, :148): clients in a random
order, each to the Gumbel argmax among the ESs it is eligible for whose
budget still covers its cost (``cost <= remaining``, no slack), the
first such ES on a tie. N dependent steps, batched over seeds; nothing
is read back to the host."""
from __future__ import annotations

from typing import Tuple

import torch


def random_assign_ref(order: torch.Tensor, gumbel: torch.Tensor,
                      costs: torch.Tensor, budgets: torch.Tensor,
                      eligible: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """order (S, N) int32 (a permutation of the clients), gumbel (S, N, M)
    float32, costs (S, N), budgets (S, M), eligible (S, N, M) bool ->
    (assign (S, N) int32, -1 = unselected; remaining (S, M) float32)."""
    s, n, m = gumbel.shape
    dev = gumbel.device
    rows = torch.arange(s, device=dev)
    assign = torch.full((s, n), -1, dtype=torch.int64, device=dev)
    remaining = budgets.to(torch.float32).clone()
    for step in range(n):
        i = order[:, step].long()
        c = costs[rows, i]
        feas = eligible[rows, i] & (c[:, None] <= remaining)
        g = torch.where(feas, gumbel[rows, i],
                        torch.full_like(remaining, -torch.inf))
        j = torch.argmax(g, dim=-1)                 # first max on ties
        ok = feas.any(dim=-1)
        assign[rows, i] = torch.where(ok, j, assign[rows, i])
        remaining[rows, j] = torch.where(ok, remaining[rows, j] + (-c),
                                         remaining[rows, j])
    return assign.to(torch.int32), remaining
