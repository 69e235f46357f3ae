"""The policy registry: every selection policy is built one way.

    from repro_torch import policies
    spec = policies.PolicySpec.from_experiment(cfg, horizon=300)
    pol = policies.make("cocs", spec, h_t=5)
    shim = policies.make_legacy("cocs", spec, seed=0, h_t=5)  # on CUDA

Registered names (case-insensitive): the tensor policies ``cocs``,
``oracle`` and ``random`` (a leading seed axis, driven by the engines of
``policies.engine``, ``sim.engine`` and ``experiment``), and the
host-state policies ``cucb``, ``linucb`` and ``cocs-phased`` (the
reference's numpy engines, one seed at a time on ``RoundData``:
``run_rounds_host``, or ``PolicyAdapter``). ``make_legacy`` wraps any
of them in a ``PolicyAdapter``, the reference's legacy ``select(rd)`` /
``update(rd, assign)`` interface (a tensor policy one seed on
``device``: ``None`` means CUDA). The engines' functions are exported
here, as ``repro.policies`` exports them.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.kernels.common import resolve_device

from repro_torch.policies.base import (FunctionalPolicy, PolicyAdapter,
                                       PolicySpec, Round, round_from_arrays,
                                       round_from_data, rounds_to_scan_axes,
                                       stack_rounds)
from repro_torch.policies.baselines import (CUCB, HostCOCS, LinUCB, Oracle,
                                            Random)
from repro_torch.policies.cocs import COCS, COCSState
from repro_torch.policies.engine import (policy_scan_step, run_rounds,
                                         run_rounds_grid,
                                         run_rounds_grid_params,
                                         run_rounds_host,
                                         run_rounds_multi_seed,
                                         stack_rounds_multi, stack_states,
                                         traced_utility)
from repro_torch.policies.solvers import (feasible_cohort_bound,
                                          flgreedy_assign, greedy_assign,
                                          random_assign)

_REGISTRY: Dict[str, Callable[..., FunctionalPolicy]] = {
    "cocs": COCS, "oracle": Oracle, "random": Random, "cucb": CUCB,
    "linucb": LinUCB,
    "cocs-phased": lambda spec, **kw: HostCOCS(spec=spec, phased=True,
                                                **kw)}


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make(name: str, spec: PolicySpec, **overrides) -> FunctionalPolicy:
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown policy {name!r}; the port has {names()}")
    return _REGISTRY[key](spec=spec, **overrides)


def make_legacy(name: str, spec: PolicySpec, seed: int = 0, device=None,
                **overrides) -> PolicyAdapter:
    """``make(name, spec, **overrides)`` in a ``PolicyAdapter``; a tensor
    policy runs on ``device`` (``None``: CUDA, raising without one)."""
    policy = make(name, spec, **overrides)
    dev = resolve_device(device) if policy.tensor_capable else None
    return PolicyAdapter(policy, seed=seed, device=dev)


__all__ = [
    "COCS", "COCSState", "CUCB", "FunctionalPolicy", "HostCOCS", "LinUCB",
    "Oracle", "PolicyAdapter", "PolicySpec", "Random", "Round",
    "feasible_cohort_bound", "flgreedy_assign", "greedy_assign", "make",
    "make_legacy", "names", "policy_scan_step", "random_assign",
    "round_from_arrays", "round_from_data", "rounds_to_scan_axes",
    "run_rounds", "run_rounds_grid", "run_rounds_grid_params",
    "run_rounds_host",
    "run_rounds_multi_seed", "stack_rounds", "stack_rounds_multi",
    "stack_states", "traced_utility",
]
