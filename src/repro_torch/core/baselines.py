"""Benchmark policies from Section VI-B on the host, in numpy (a copy of
the reference's ``core/baselines.py``): CUCB and LinUCB over a pool of
decisions that ``RandomPolicy`` draws, each with its own
``np.random.default_rng(seed)`` stream."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.core.network import RoundData
from repro_torch.core.selection import (SelectionProblem,
                                        flgreedy_select, greedy_select)


class BasePolicy:
    name = "base"

    def __init__(self, num_clients: int, num_edge_servers: int, budget: float,
                 sqrt_utility: bool = False, seed: int = 0):
        self.n = num_clients
        self.m = num_edge_servers
        self.budget = budget
        self.sqrt_utility = sqrt_utility
        self.rng = np.random.default_rng(seed)

    def _budgets(self) -> np.ndarray:
        return np.full(self.m, float(self.budget))

    def _solve(self, prob: SelectionProblem) -> np.ndarray:
        if self.sqrt_utility:
            return flgreedy_select(prob)
        return greedy_select(prob)

    def select(self, rd: RoundData) -> np.ndarray:
        raise NotImplementedError

    def update(self, rd: RoundData, assign: np.ndarray) -> None:
        pass


class RandomPolicy(BasePolicy):
    """Random feasible assignment under the two constraints."""
    name = "Random"

    def select(self, rd: RoundData) -> np.ndarray:
        assign = np.full(self.n, -1, np.int64)
        remaining = self._budgets()
        for i in self.rng.permutation(self.n):
            cands = [j for j in range(self.m)
                     if rd.eligible[i, j] and rd.costs[i] <= remaining[j]]
            if not cands:
                continue
            j = int(self.rng.choice(cands))
            assign[i] = j
            remaining[j] -= rd.costs[i]
        return assign


class CUCBPolicy(BasePolicy):
    """Combinatorial UCB with whole-decision arms (Sec. VI-B.2).

    The paper's CUCB treats each feasible NO decision s as one arm — the arm
    set is huge, which is exactly why it underperforms. We materialize a
    sampled pool of feasible decisions (static snapshot, as the paper fixes
    static resources for CUCB) and run UCB1 over the pool.
    """
    name = "CUCB"

    def __init__(self, *args, pool_size: int = 200, **kwargs):
        super().__init__(*args, **kwargs)
        self.pool_size = pool_size
        self.pool: Optional[np.ndarray] = None     # (P, N) assignments
        self.counts = np.zeros(pool_size)
        self.means = np.zeros(pool_size)
        self.t = 0

    def _build_pool(self, rd: RoundData):
        rnd = RandomPolicy(self.n, self.m, self.budget,
                           seed=int(self.rng.integers(1 << 31)))
        pool = []
        for _ in range(self.pool_size):
            pool.append(rnd.select(rd))
        self.pool = np.array(pool)

    def _project(self, assign: np.ndarray, rd: RoundData) -> np.ndarray:
        """Drop assignments that are infeasible this round."""
        out = assign.copy()
        remaining = self._budgets()
        for i in range(self.n):
            j = out[i]
            if j < 0:
                continue
            if not rd.eligible[i, j] or rd.costs[i] > remaining[j]:
                out[i] = -1
            else:
                remaining[j] -= rd.costs[i]
        return out

    def select(self, rd: RoundData) -> np.ndarray:
        if self.pool is None:
            self._build_pool(rd)
        self.t += 1
        ucb = np.where(
            self.counts > 0,
            self.means + np.sqrt(2 * math.log(max(self.t, 2))
                                 / np.maximum(self.counts, 1)),
            np.inf)
        self._last_arm = int(np.argmax(ucb))
        return self._project(self.pool[self._last_arm], rd)

    def update(self, rd: RoundData, assign: np.ndarray) -> None:
        sel = assign >= 0
        reward = float(rd.outcomes[np.arange(self.n)[sel], assign[sel]].sum())
        if self.sqrt_utility:
            reward = math.sqrt(max(reward, 0.0) / self.m)
        a = self._last_arm
        self.counts[a] += 1
        self.means[a] += (reward - self.means[a]) / self.counts[a]


class LinUCBPolicy(CUCBPolicy):
    """The paper's LinUCB (Sec. VI-B.3): "a contextual variant of running
    CUCB" — arms are whole NO decisions from the same sampled pool, and the
    utility of an arm is modelled as linear in the aggregate context features
    of its selected client-ES pairs. (A *per-pair* linear model would be a
    COCS-style decomposition — exactly what these baselines lack.)"""
    name = "LinUCB"

    def __init__(self, *args, lam: float = 1.0, beta: float = 0.8, **kwargs):
        super().__init__(*args, **kwargs)
        self.d = 5
        self.beta = beta
        self.A = np.eye(self.d) * lam
        self.bvec = np.zeros(self.d)

    def _arm_features(self, assign: np.ndarray, rd: RoundData) -> np.ndarray:
        sel = assign >= 0
        idx = np.nonzero(sel)[0]
        phi = np.nan_to_num(rd.contexts)[idx, assign[idx]]  # (k, 2)
        k = len(idx)
        if k == 0:
            return np.array([1.0, 0, 0, 0, 0])
        return np.array([1.0, phi[:, 0].sum(), phi[:, 1].sum(),
                         (phi[:, 0] * phi[:, 1]).sum(), float(k)])

    def select(self, rd: RoundData) -> np.ndarray:
        if self.pool is None:
            self._build_pool(rd)
        self.t += 1
        a_inv = np.linalg.inv(self.A)
        theta = a_inv @ self.bvec
        best, best_score = 0, -np.inf
        feats = []
        for p_idx in range(self.pool_size):
            assign = self._project(self.pool[p_idx], rd)
            x = self._arm_features(assign, rd)
            feats.append((assign, x))
            score = float(theta @ x
                          + self.beta * np.sqrt(max(x @ a_inv @ x, 0.0)))
            if score > best_score:
                best, best_score = p_idx, score
        self._last_arm = best
        self._last_x = feats[best][1]
        return feats[best][0]

    def update(self, rd: RoundData, assign: np.ndarray) -> None:
        sel = assign >= 0
        reward = float(rd.outcomes[np.arange(self.n)[sel], assign[sel]].sum())
        if self.sqrt_utility:
            reward = math.sqrt(max(reward, 0.0) / self.m)
        x = self._last_x
        self.A += np.outer(x, x)
        self.bvec += reward * x
