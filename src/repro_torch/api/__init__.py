"""Declarative experiment API: one serializable spec, one entry point.

    from repro_torch import api

    spec = api.ExperimentSpec(
        policy=api.PolicySpec("cocs"),
        env=api.EnvSpec("metropolis-1k", true_p="analytic"),
        horizon=400, seeds=(0, 1))
    res = api.run(spec)              # or repro_torch.run(spec); CUDA
    res.tier                         # 1: the bandit tier
    res.cumulative_utility()         # (S, T)
    api.run(spec, device="cpu")      # the plain PyTorch path

The spec is the reference's (``repro.api``): the same JSON drives
either package. ``run`` picks the tier by the reference's rules: 1
(bandit-only), 2 (training with a host-state policy), 3 (training on a
host env, ``EnvSpec("paper")``), 4 (training on a device env); a grid
(``spec.grid(budget=[...])``) gives a ``GridResult``. What the port
does not have yet raises ``NotImplementedError`` naming its ROADMAP
item (``api.run``).
"""
from __future__ import annotations

from repro_torch.api.grid import GridResult, run_grid
from repro_torch.api.run import (RunResult, build_env, build_policy,
                                 cached_rollout, resolve_config, run,
                                 select_tier)
from repro_torch.api.spec import (GRID_AXES, EnvSpec, EvalSpec,
                                  ExperimentGrid, ExperimentSpec,
                                  PolicySpec, ShardSpec, TrainSpec,
                                  env_spec_from_config)

__all__ = [
    "EnvSpec", "EvalSpec", "ExperimentGrid", "ExperimentSpec", "GRID_AXES",
    "GridResult", "PolicySpec", "RunResult", "ShardSpec", "TrainSpec",
    "build_env", "build_policy", "cached_rollout", "env_spec_from_config",
    "resolve_config", "run", "run_grid", "select_tier",
]
