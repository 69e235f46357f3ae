"""Functional policy API: a frozen config dataclass with pure
``init``/``select``/``update`` on tensors.

    state          = policy.init(num_seeds, device, seeds)
    assign, aux    = policy.select(state, rd)
    state          = policy.update(state, rd, assign, aux)

Every tensor carries a leading seed axis ``S``: one call selects for
all seeds at once (the reference ``vmap``s the same functions).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.configs.paper_hfl import HFLExperimentConfig


class Round(NamedTuple):
    """One round's observables (tensors with a leading seed axis)."""
    t: Any            # (S,) int32 round index
    contexts: Any     # (S, N, M, 2)
    eligible: Any     # (S, N, M) bool
    costs: Any        # (S, N)
    outcomes: Any     # (S, N, M)
    true_p: Any       # (S, N, M)
    latency: Any      # (S, N, M) realized tau


@dataclass(frozen=True)
class PolicySpec:
    """Problem dimensions shared by every policy."""
    num_clients: int
    num_edge_servers: int
    budget: float
    horizon: int
    sqrt_utility: bool = False

    @classmethod
    def from_experiment(cls, cfg: HFLExperimentConfig, horizon: int,
                        budget: Optional[float] = None) -> "PolicySpec":
        return cls(num_clients=cfg.num_clients,
                   num_edge_servers=cfg.num_edge_servers,
                   budget=float(cfg.budget if budget is None else budget),
                   horizon=horizon,
                   sqrt_utility=cfg.utility == "sqrt")

    def budgets(self) -> np.ndarray:
        return np.full(self.num_edge_servers, self.budget, np.float32)


@dataclass(frozen=True)
class FunctionalPolicy:
    """Base for policies: frozen, hashable, pure functions of tensors."""
    spec: PolicySpec

    name: str = "base"

    def init(self, num_seeds: int, device=None, seeds=None):
        """The state for ``num_seeds`` seeds; a policy that draws keys
        takes them from ``seeds`` (default ``0 .. num_seeds - 1``)."""
        raise NotImplementedError

    def select(self, state, rd: Round) -> Tuple[Any, Any]:
        raise NotImplementedError

    def update(self, state, rd: Round, assign, aux=None):
        return state
