"""COCS — Context-aware Online Client Selection (Algorithm 1).

Faithful implementation of the paper's CC-MAB policy:
  * context space [0,1]^2 partitioned into h_T^2 hypercubes;
  * per-(client, ES, hypercube) counters C and participation estimates p-hat;
  * a round *explores* if any eligible pair's hypercube has C <= K(t) =
    t^z log t, else *exploits* by solving P2 on the estimates;
  * exploration stage 1 maximizes the number of under-explored pairs
    (Eq. 14/15), stage 2 spends leftover budget on explored clients by
    estimated utility (Eq. 17);
  * update phase folds observed outcomes into (C, p-hat) (Alg. 1 l.14-19).

Theorem 2 parameters: z = 2a/(3a+2), h_T = ceil(T^{z/(2a)}) for Holder
exponent a. The paper's Table I fixes h_T = 5 for its experiments.

This is the host form, in numpy (a copy of the reference's
``core/cocs.py``): the phased variant (``cocs-phased``) runs it. The
tensor policy ``policies.cocs.COCS`` is the index mode on every seed at
once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.network import RoundData
from repro_torch.core.selection import (SelectionProblem,
                                        flgreedy_select, greedy_select)


def theorem2_params(horizon: int, alpha: float = 1.0) -> Tuple[float, int]:
    """Returns (z, h_T) from Theorem 2."""
    z = 2 * alpha / (3 * alpha + 2)
    h_t = max(1, math.ceil(horizon ** (z / (2 * alpha))))
    return z, h_t


@dataclass
class COCSConfig:
    num_clients: int
    num_edge_servers: int
    horizon: int
    budget: float                   # B per ES (total budget / M)
    alpha: float = 1.0
    h_t: Optional[int] = None       # context partition per dim (None = Thm 2)
    z: Optional[float] = None       # exploration exponent (None = Thm 2)
    sqrt_utility: bool = False      # non-convex HFL (Section V)
    flgreedy_eps: float = 0.3
    # multiplier on K(t). Theory uses 1.0; the paper's experiments converge to
    # near-oracle by round ~120 (Table II), which with N*M*h_T^2 counter cells
    # and only ~B/c_min selections per round requires a much milder effective
    # exploration threshold. 
    k_scale: float = 1.0
    # UCB-style confidence coefficient used to break ties among the
    # under-explored pairs of Eq. (14)/(15) (the paper leaves this choice
    # free); smaller = trust p-hat sooner.
    bonus_scale: float = 0.35
    # True  -> Algorithm-1-faithful two-phase selection (under-explored pairs
    #          get absolute budget priority via Eq. 14/15, then Eq. 17).
    # False -> single-pass index selection: one greedy over all eligible
    #          pairs, under-explored pairs valued optimistically. The phased
    #          variant exhibits a pathology when K(t) outpaces the visit rate
    #          (well-learned good pairs are crowded out by uncertain ones and
    #          regret *grows*);
    phased: bool = False


class COCSPolicy:
    name = "COCS"

    def __init__(self, cfg: COCSConfig):
        self.cfg = cfg
        z_thm, h_thm = theorem2_params(cfg.horizon, cfg.alpha)
        self.z = cfg.z if cfg.z is not None else z_thm
        self.h_t = cfg.h_t if cfg.h_t is not None else h_thm
        n, m, h = cfg.num_clients, cfg.num_edge_servers, self.h_t
        self.counters = np.zeros((n, m, h, h), np.int64)
        self.p_hat = np.zeros((n, m, h, h), np.float64)
        self.last_explored = False

    # -- helpers -------------------------------------------------------------

    def k_of_t(self, t: int) -> float:
        return self.cfg.k_scale * (t ** self.z) * math.log(max(t, 2))

    def cube_index(self, contexts: np.ndarray) -> np.ndarray:
        """contexts (N, M, 2) -> integer cube coords (N, M, 2)."""
        idx = np.floor(np.nan_to_num(contexts) * self.h_t).astype(np.int64)
        return np.clip(idx, 0, self.h_t - 1)

    def _gather(self, arr: np.ndarray, cubes: np.ndarray) -> np.ndarray:
        n, m = arr.shape[:2]
        ii, jj = np.meshgrid(np.arange(n), np.arange(m), indexing="ij")
        return arr[ii, jj, cubes[..., 0], cubes[..., 1]]

    # -- Algorithm 1 ----------------------------------------------------------

    def select(self, rd: RoundData) -> np.ndarray:
        cubes = self.cube_index(rd.contexts)
        counts = self._gather(self.counters, cubes)      # (N, M)
        est = self._gather(self.p_hat, cubes)            # (N, M)
        under_explored = rd.eligible & (counts <= self.k_of_t(rd.t + 1))
        self.last_explored = bool(under_explored.any())
        # optimistic value for under-explored pairs: unvisited cells count as
        # 1, visited cells as p-hat + confidence bonus. The paper's Eq. 14/15
        # only require maximizing |s| over the under-explored set and leave
        # the choice among them free; we break ties UCB-style.
        bonus = self.cfg.bonus_scale * np.sqrt(
            2.0 * math.log(max(rd.t + 1, 2)) / np.maximum(counts, 1))
        optimistic = np.where(counts == 0, 1.0, np.minimum(est + bonus, 1.0))
        if self.cfg.phased and self.last_explored:
            # Algorithm-1-faithful: under-explored pairs get absolute budget
            # priority (Eq. 14/15), leftover spent on explored pairs (Eq. 17)
            prob = SelectionProblem(values=est, costs=rd.costs,
                                    budgets=self._budgets(rd),
                                    eligible=rd.eligible)
            explore_prob = SelectionProblem(
                values=np.where(under_explored, optimistic, 0.0),
                costs=rd.costs, budgets=prob.budgets,
                eligible=rd.eligible & under_explored)
            assign = greedy_select(explore_prob)
            spent = np.zeros(prob.m)
            for j in range(prob.m):
                spent[j] = rd.costs[assign == j].sum()
            residual = SelectionProblem(
                values=np.where(under_explored, 0.0, est),
                costs=rd.costs,
                budgets=prob.budgets - spent,
                eligible=rd.eligible & (assign < 0)[:, None])
            fill = self._solve(residual)
            return np.where(assign >= 0, assign, fill)
        # index mode (default): one solve over all eligible pairs
        values = np.where(under_explored, optimistic, est)
        prob = SelectionProblem(values=values, costs=rd.costs,
                                budgets=self._budgets(rd),
                                eligible=rd.eligible)
        return self._solve(prob)

    def _solve(self, prob: SelectionProblem) -> np.ndarray:
        if self.cfg.sqrt_utility:
            return flgreedy_select(prob, eps=self.cfg.flgreedy_eps)
        return greedy_select(prob)

    def _budgets(self, rd: RoundData) -> np.ndarray:
        return np.full(self.cfg.num_edge_servers, float(self.cfg.budget))

    def update(self, rd: RoundData, assign: np.ndarray) -> None:
        cubes = self.cube_index(rd.contexts)
        for i in np.nonzero(assign >= 0)[0]:
            j = int(assign[i])
            a, b = cubes[i, j]
            x = float(rd.outcomes[i, j])
            c = self.counters[i, j, a, b]
            self.p_hat[i, j, a, b] = (self.p_hat[i, j, a, b] * c + x) / (c + 1)
            self.counters[i, j, a, b] = c + 1
