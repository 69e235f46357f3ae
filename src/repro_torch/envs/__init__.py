"""Environment registry: scenario-preset HFL network environments on the
host (float64 numpy), as the reference's ``repro.envs``.

    from repro_torch import envs
    env = envs.make("flash-crowd")             # paper cfg, surge pricing
    env = envs.make("paper", CIFAR10_NONCONVEX)
    env = envs.make("high-mobility", mobility=0.8)   # knob override
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

from repro_torch.configs.paper_hfl import HFLExperimentConfig, MNIST_CONVEX
from repro_torch.envs.base import EnvState, HFLEnv, cached_rollout
from repro_torch.envs.scenarios import SCENARIOS, ScenarioSim, ScenarioSpec


def available() -> Tuple[str, ...]:
    return tuple(sorted(SCENARIOS))


def make(name: str = "paper", cfg: Optional[HFLExperimentConfig] = None,
         true_p: str = "mc", faults=None, **overrides) -> HFLEnv:
    key = name.lower()
    if key not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; available: {available()}")
    spec = SCENARIOS[key]
    if overrides:
        spec = replace(spec, **overrides)
    return HFLEnv(cfg=cfg or MNIST_CONVEX, spec=spec, true_p=true_p,
                  faults=faults)


__all__ = ["EnvState", "HFLEnv", "SCENARIOS", "ScenarioSim", "ScenarioSpec",
           "available", "cached_rollout", "make"]
