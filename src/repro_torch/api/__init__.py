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
either package. ``run`` picks tier 1 (bandit-only) or tier 4 (training
in the loop, ``train=api.TrainSpec()``) on a device env; the rest
raises ``NotImplementedError`` naming its ROADMAP item (``api.run``).
"""
from __future__ import annotations

from repro_torch.api.run import (RunResult, build_env, build_policy,
                                 resolve_config, run, select_tier)
from repro_torch.api.spec import (GRID_AXES, EnvSpec, EvalSpec,
                                  ExperimentGrid, ExperimentSpec,
                                  PolicySpec, ShardSpec, TrainSpec,
                                  env_spec_from_config)

__all__ = [
    "EnvSpec", "EvalSpec", "ExperimentGrid", "ExperimentSpec", "GRID_AXES",
    "PolicySpec", "RunResult", "ShardSpec", "TrainSpec", "build_env",
    "build_policy", "env_spec_from_config", "resolve_config", "run",
    "select_tier",
]
