"""Client-selection problem (P2/P3) and its host solvers, in numpy (a
copy of the reference's ``core/selection.py``: the problem, the density
greedy and FLGreedy; the host policies of ``core.baselines`` and
``core.cocs`` solve with them).

P2 (strongly convex, linear utility): max Σ_{(n,m)∈s} v[n,m]
subject to per-ES knapsack (Σ_{n∈s_m} c[n] <= B_m) and a partition matroid
(each client assigned to at most one ES, only to eligible ESs).

P3 (non-convex): max sqrt((1/M) Σ v) — monotone submodular; solved with a
lazy greedy (FLGreedy-style cost-benefit) giving the paper's
1/((1+eps)(2+2M)) guarantee.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass
class SelectionProblem:
    values: np.ndarray      # (N, M) expected participation per client-ES pair
    costs: np.ndarray       # (N,)   cost of renting client n this round
    budgets: np.ndarray     # (M,)   per-ES budget B
    eligible: np.ndarray    # (N, M) bool, client n can reach ES m

    @property
    def n(self) -> int:
        return self.values.shape[0]

    @property
    def m(self) -> int:
        return self.values.shape[1]


# ---------------------------------------------------------------------------
# greedy (density) solver for P2 — the scalable oracle approximation


def greedy_select(prob: SelectionProblem) -> np.ndarray:
    """Greedy by value density v/c over all feasible (n, m) pairs.

    Returns assign (N,): ES index per client, -1 = unselected.
    """
    n, m = prob.n, prob.m
    assign = np.full(n, -1, np.int64)
    remaining = prob.budgets.astype(np.float64).copy()
    d = np.where(prob.eligible,
                 prob.values / np.maximum(prob.costs[:, None], 1e-12),
                 -np.inf)
    # stable sort so exact ties break deterministically (toward the larger
    # flat index after reversal) — the vectorized JAX solver matches this
    order = np.argsort(d, axis=None, kind="stable")[::-1]
    for flat in order:
        i, j = divmod(int(flat), m)
        if not np.isfinite(d.flat[flat]) or d.flat[flat] <= 0:
            break
        if assign[i] >= 0 or prob.costs[i] > remaining[j] + 1e-12:
            continue
        assign[i] = j
        remaining[j] -= prob.costs[i]
    return assign


# ---------------------------------------------------------------------------
# FLGreedy (lazy greedy, cost-benefit) for the submodular P3


def flgreedy_select(prob: SelectionProblem, eps: float = 0.3,
                    utility_fn: Optional[Callable[[float], float]] = None
                    ) -> np.ndarray:
    """Lazy greedy for monotone submodular max under M knapsacks + matroid
    (Badanidiyuru & Vondrak style). utility_fn maps Σv -> utility
    (default sqrt(total/M), Eq. 19). Lazy evaluation exploits submodularity:
    stale upper bounds are popped from a max-heap and refreshed.
    """
    n, m = prob.n, prob.m
    if utility_fn is None:
        def utility_fn(total: float) -> float:
            return float(np.sqrt(max(total, 0.0) / prob.m))

    assign = np.full(n, -1, np.int64)
    remaining = prob.budgets.astype(np.float64).copy()
    total_v = 0.0
    cur_util = utility_fn(total_v)

    def marginal(i: int, j: int) -> float:
        return utility_fn(total_v + prob.values[i, j]) - cur_util

    heap = []  # (-gain_per_cost, gain, i, j)
    for i in range(n):
        for j in range(m):
            if prob.eligible[i, j] and prob.costs[i] > 0:
                g = marginal(i, j)
                heapq.heappush(heap, (-g / prob.costs[i], g, i, j))
    while heap:
        neg_d, g_stale, i, j = heapq.heappop(heap)
        if assign[i] >= 0 or prob.costs[i] > remaining[j] + 1e-12:
            continue
        g = marginal(i, j)
        if g <= 1e-15:
            continue
        d = g / prob.costs[i]
        if heap and d < -heap[0][0] - 1e-15:     # stale: reinsert
            heapq.heappush(heap, (-d, g, i, j))
            continue
        assign[i] = j
        remaining[j] -= prob.costs[i]
        total_v += prob.values[i, j]
        cur_util = utility_fn(total_v)
    return assign
