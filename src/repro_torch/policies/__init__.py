"""The policy registry: every selection policy is built one way.

    from repro_torch import policies
    spec = policies.PolicySpec.from_experiment(cfg, horizon=300)
    pol = policies.make("cocs", spec, h_t=5)

Registered names (case-insensitive): ``cocs``, ``oracle``, ``random``.
The reference's host-state policies ``cucb``, ``linucb`` and
``cocs-phased`` are not ported (ROADMAP queue A item 3): ``make`` raises
``KeyError`` for them, naming that item. The tier-[1] engine's functions
are exported here, as ``repro.policies`` exports them.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.policies.base import (FunctionalPolicy, PolicySpec, Round,
                                       round_from_arrays)
from repro_torch.policies.baselines import Oracle, Random
from repro_torch.policies.cocs import COCS, COCSState
from repro_torch.policies.engine import (policy_scan_step, run_rounds,
                                         run_rounds_grid,
                                         run_rounds_grid_params,
                                         run_rounds_multi_seed,
                                         stack_rounds_multi, stack_states,
                                         traced_utility)
from repro_torch.policies.solvers import (feasible_cohort_bound,
                                          flgreedy_assign, greedy_assign,
                                          random_assign)

_REGISTRY: Dict[str, Callable[..., FunctionalPolicy]] = {
    "cocs": COCS, "oracle": Oracle, "random": Random}
# the reference's host-state policies, which wrap its numpy engines
NOT_PORTED = ("cucb", "linucb", "cocs-phased")


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make(name: str, spec: PolicySpec, **overrides) -> FunctionalPolicy:
    key = name.lower()
    if key in NOT_PORTED:
        raise KeyError(f"policy {name!r} is a host-state policy of the "
                       "reference, not ported yet (ROADMAP queue A item "
                       f"3); the port has {names()}")
    if key not in _REGISTRY:
        raise KeyError(f"unknown policy {name!r}; the port has {names()}")
    return _REGISTRY[key](spec=spec, **overrides)


__all__ = [
    "COCS", "COCSState", "FunctionalPolicy", "Oracle", "PolicySpec",
    "Random", "Round", "feasible_cohort_bound", "flgreedy_assign",
    "greedy_assign", "make", "names", "policy_scan_step", "random_assign",
    "round_from_arrays", "run_rounds", "run_rounds_grid",
    "run_rounds_grid_params", "run_rounds_multi_seed",
    "stack_rounds_multi", "stack_states", "traced_utility",
]
