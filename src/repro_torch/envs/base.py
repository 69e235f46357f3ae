"""Functional environment API over the host network simulator (a copy of
the reference's ``envs/base.py``).

    env = envs.make("high-mobility", cfg)
    state = env.init(seed)
    state, rd = env.step(state)        # pure: the input state is unchanged
    rounds = env.rollout(seed, horizon)

Randomness is counter-based (``sim.draws``), addressed by ``(seed, t)``,
so the only state ``round()`` advances is the mobility positions:
``step`` copies those and nothing else. ``rollout`` advances one
simulator in place; ``cached_rollout`` keeps the last few rollouts, so
the runs that share an (env, seed, horizon) (the five policies of a
panel, a grid's cells) share one realization; ``rollout_multi`` stacks
a seed sweep's cached rollouts into one ``(S, T, ...)`` batch of numpy
arrays in the ``Round`` field order (``policies.base.round_from_arrays``
makes tensors of it).

The host env is the reference's design: float64 numpy on the host, its
rounds cast to float32 ``Round`` tensors when a policy or the training
block takes them. The device simulator ``sim.core`` is its float32 twin.
"""
from __future__ import annotations

import copy
import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.paper_hfl import HFLExperimentConfig
from repro_torch.core.network import HFLNetworkSim, RoundData
from repro_torch.envs.scenarios import ScenarioSim, ScenarioSpec


@dataclass
class EnvState:
    sim: HFLNetworkSim
    t: int = 0


@dataclass(frozen=True)
class HFLEnv:
    """A (config, scenario) pair with functional init/step."""
    cfg: HFLExperimentConfig
    spec: ScenarioSpec
    true_p: str = "mc"     # "mc" | "analytic" (exact Eq. 6, sim.truep)
    # an optional sim.faults.FaultSpec (frozen, so the env stays
    # hashable); the device env injects the same fault events
    faults: Optional[object] = None

    @property
    def name(self) -> str:
        return self.spec.name

    def make_sim(self, seed: int = 0) -> HFLNetworkSim:
        return ScenarioSim(self.cfg, self.spec, seed=seed,
                           true_p_mode=self.true_p, faults=self.faults)

    def init(self, seed: int = 0) -> EnvState:
        return EnvState(sim=self.make_sim(seed), t=0)

    def step(self, state: EnvState,
             t: Optional[int] = None) -> tuple:
        """(state, t?) -> (new_state, RoundData). Pure: copies only the
        mutable sim state (the client positions)."""
        sim = copy.copy(state.sim)
        sim.client_pos = state.sim.client_pos.copy()
        tt = state.t if t is None else t
        rd = sim.round(tt)
        return EnvState(sim=sim, t=tt + 1), rd

    def rollout(self, seed: int, horizon: int) -> List[RoundData]:
        """Realize ``horizon`` rounds in place (no copies)."""
        sim = self.make_sim(seed)
        return [sim.round(t) for t in range(horizon)]

    def rollout_multi(self, seeds: Sequence[int], horizon: int):
        """A seed sweep as one stacked ``(S, T, ...)`` batch of numpy
        arrays (``policies.base.Round`` fields, the reference's float32
        dtypes), from the cached rollouts."""
        from repro_torch.policies.base import Round, stack_rounds
        per_seed = [stack_rounds(cached_rollout(self, int(s), horizon))
                    for s in seeds]
        return Round(*(np.stack(f) for f in zip(*per_seed)))


# Frozen env objects hash by value, so repeated runs over the same (env,
# seed, horizon) share one realization instead of drawing it again.
@functools.lru_cache(maxsize=8)
def cached_rollout(env: HFLEnv, seed: int, horizon: int
                   ) -> Tuple[RoundData, ...]:
    """A host env's ``horizon`` rounds of ``seed`` (``RoundData``)."""
    return tuple(env.rollout(seed, horizon))
