"""Per-round selection solvers (P2, P3 and Random's).

``greedy_assign`` is the P2 density greedy: take the highest-density
still-feasible (client, ES) pair until none is left, ties toward the
larger flat index. It runs as ``kernels.budgeted_topk``: on a CUDA
device one hand-written kernel does the density, the sort and the budget
walk for every seed in one launch; on the CPU the plain version walks
the sorted candidate segments one pick at a time.

``flgreedy_assign`` is the exact (non-lazy) FLGreedy for the sqrt
utility of P3: every pick rescores every feasible pair by marginal gain
over cost (``kernels.budgeted_topk.flgreedy_topk``: B2's sort, then P3's
walk kernel on CUDA).

``random_assign`` is Random's feasible random assignment: a random client
order, each client to the Gumbel argmax among its still-feasible ESs
(``kernels.random_assign``: the draws, then a scan kernel on CUDA).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.budgeted_topk.ops import (budgeted_topk,
                                                   flgreedy_topk)
from repro_torch.kernels.random_assign import ops as random_ops


def feasible_cohort_bound(budget: float, min_cost: float,
                          num_clients: int) -> int:
    """Largest per-ES cohort any budget-feasible assignment can produce:
    ``floor(B / min cost)`` (every solver adds a client only while its
    cost fits the remaining budget)."""
    if min_cost <= 0.0:
        return int(num_clients)
    return int(min(num_clients,
                   max(1, math.floor(budget / min_cost + 1e-9))))


def greedy_assign(values: torch.Tensor, costs: torch.Tensor,
                  budgets: torch.Tensor, eligible: torch.Tensor
                  ) -> torch.Tensor:
    """Density greedy for P2. values (S, N, M), costs (S, N), budgets
    (S, M) or (M,), eligible (S, N, M) bool -> assign (S, N) int32
    (-1 = unselected)."""
    return budgeted_topk(values, costs, budgets, eligible)


def flgreedy_assign(values: torch.Tensor, costs: torch.Tensor,
                    budgets: torch.Tensor, eligible: torch.Tensor
                    ) -> torch.Tensor:
    """Cost-benefit greedy for P3, utility ``sqrt(total / M)``. Shapes as
    ``greedy_assign``."""
    return flgreedy_topk(values, costs, budgets, eligible)


def random_assign(key: torch.Tensor, costs: torch.Tensor,
                  budgets: torch.Tensor, eligible: torch.Tensor
                  ) -> torch.Tensor:
    """Feasible random assignment: key (S, 2), costs (S, N), budgets
    (S, M) or (M,), eligible (S, N, M) bool -> assign (S, N) int32."""
    return random_ops.random_assign(key, costs, budgets, eligible)
