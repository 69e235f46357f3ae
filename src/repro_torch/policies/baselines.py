"""The paper's benchmark policies of Section VI-B: ``Oracle`` and
``Random`` on tensors, and the host-state policies ``CUCB``, ``LinUCB``
and ``HostCOCS`` (the reference's ``policies/baselines.py``).

``Oracle`` knows each round's realized outcomes and solves the round's
problem on them (P2's density greedy, or P3's FLGreedy under the sqrt
utility): an upper bound. ``Random`` assigns each client, in a random
order, to a uniformly drawn ES it can still afford; its key folds in the
round index, so its state never changes. Both carry a leading seed axis,
as every tensor policy of the port.

``CUCB``, ``LinUCB`` and ``HostCOCS`` keep the reference's numpy engines
(``core.baselines``, ``core.cocs``) behind the same functional interface:
their state is one engine object for one seed, they select on a host
``RoundData``, and they launch no kernel (``tensor_capable = False``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core import baselines as legacy
from repro_torch.core.cocs import COCSConfig, COCSPolicy
from repro_torch.core.network import RoundData
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


# ---------------------------------------------------------------------------
# host-state policies: the state is the numpy engine of one seed


@dataclass(frozen=True)
class _HostPolicy(FunctionalPolicy):
    """Functional facade over a stateful numpy policy. ``init(seed)``
    makes the state of one seed; ``select`` takes a ``RoundData``."""
    tensor_capable: ClassVar[bool] = False

    def _make(self, seed: int):
        raise NotImplementedError

    def init(self, seed: int = 0):
        return self._make(int(seed))

    def select(self, state, rd):
        if not isinstance(rd, RoundData):
            raise TypeError(f"{self.name} is a host policy and needs "
                            "RoundData rounds (tensor_capable=False)")
        aux = {}
        assign = state.select(rd)
        if hasattr(state, "last_explored"):
            aux["explored"] = bool(state.last_explored)
        return assign, aux

    def update(self, state, rd, assign, aux=None):
        state.update(rd, np.asarray(assign, np.int64))
        return state


@dataclass(frozen=True)
class CUCB(_HostPolicy):
    pool_size: int = 200
    name: str = field(default="CUCB")

    def _make(self, seed: int):
        s = self.spec
        return legacy.CUCBPolicy(s.num_clients, s.num_edge_servers, s.budget,
                                 s.sqrt_utility, seed,
                                 pool_size=self.pool_size)


@dataclass(frozen=True)
class LinUCB(_HostPolicy):
    pool_size: int = 200
    lam: float = 1.0
    beta: float = 0.8
    name: str = field(default="LinUCB")

    def _make(self, seed: int):
        s = self.spec
        return legacy.LinUCBPolicy(s.num_clients, s.num_edge_servers,
                                   s.budget, s.sqrt_utility, seed,
                                   pool_size=self.pool_size, lam=self.lam,
                                   beta=self.beta)


@dataclass(frozen=True)
class HostCOCS(_HostPolicy):
    """The numpy COCS, with the phased (Algorithm-1-faithful) selection
    that the tensor index-mode policy does not have."""
    alpha: float = 1.0
    h_t: Optional[int] = None
    z: Optional[float] = None
    k_scale: float = 1.0
    bonus_scale: float = 0.35
    phased: bool = False
    flgreedy_eps: float = 0.3
    name: str = field(default="COCS")

    def _make(self, seed: int):
        del seed
        s = self.spec
        return COCSPolicy(COCSConfig(
            num_clients=s.num_clients, num_edge_servers=s.num_edge_servers,
            horizon=s.horizon, budget=s.budget, alpha=self.alpha,
            h_t=self.h_t, z=self.z, sqrt_utility=s.sqrt_utility,
            flgreedy_eps=self.flgreedy_eps, k_scale=self.k_scale,
            bonus_scale=self.bonus_scale, phased=self.phased))
