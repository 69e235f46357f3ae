"""The paper's benchmark policies of Section VI-B on tensors: ``Oracle``
and ``Random`` (the reference's ``policies/baselines.py``, :31-83).

``Oracle`` knows each round's realized outcomes and solves the round's
problem on them (P2's density greedy, or P3's FLGreedy under the sqrt
utility): an upper bound. ``Random`` assigns each client, in a random
order, to a uniformly drawn ES it can still afford; its key folds in the
round index, so its state never changes. Both carry a leading seed axis,
as every policy of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, NamedTuple

import torch

from repro_torch import random as jr
from repro_torch.policies.base import FunctionalPolicy, Round
from repro_torch.policies.solvers import (flgreedy_assign, greedy_assign,
                                          random_assign)


class KeyState(NamedTuple):
    key: torch.Tensor          # (S, 2) per-seed keys


@dataclass(frozen=True)
class Oracle(FunctionalPolicy):
    """Knows the realized per-round outcomes X (upper bound)."""
    name: str = field(default="Oracle")
    tensor_capable: ClassVar[bool] = True

    def init(self, num_seeds: int, device=None, seeds=None) -> None:
        return None                    # it needs no state

    def select_with_budgets(self, state, rd: Round, budgets: torch.Tensor):
        values = rd.outcomes.to(torch.float32)
        costs = rd.costs.to(torch.float32)
        solve = flgreedy_assign if self.spec.sqrt_utility else greedy_assign
        return solve(values, costs, budgets, rd.eligible), {}


@dataclass(frozen=True)
class Random(FunctionalPolicy):
    """Feasible random assignment; the round's key is ``fold_in(key, t)``,
    so select is pure and the state never changes."""
    name: str = field(default="Random")
    tensor_capable: ClassVar[bool] = True

    def init(self, num_seeds: int, device=None, seeds=None) -> KeyState:
        """``PRNGKey(seed)`` per seed (default seeds ``0 .. S-1``)."""
        seeds = list(range(num_seeds)) if seeds is None else list(seeds)
        return KeyState(key=jr.PRNGKey(torch.as_tensor(seeds), device))

    def select_with_budgets(self, state: KeyState, rd: Round,
                            budgets: torch.Tensor):
        key = jr.fold_in(state.key, rd.t)
        return random_assign(key, rd.costs.to(torch.float32), budgets,
                             rd.eligible), {}
