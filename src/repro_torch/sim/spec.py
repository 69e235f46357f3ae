"""Static configuration for the device simulator.

``SimSpec`` flattens an ``(HFLExperimentConfig, ScenarioSpec)`` pair into
one frozen bundle of numbers: dimensions, channel physics and scenario
knobs. Derived constants (``rate_hi``, watt conversions, tier edges,
arrival window) are computed here once, in float64, with the host
formulas, so the float32 device math starts from the reference's exact
constants.

Presets: the paper-scale scenarios (``paper``, ``static-clients``,
``high-mobility``, ``tiered-pricing``) at N=50, M=3, and the cohorts
``metropolis-1k`` (1000 clients, 12 ES) and ``bursty-arrival`` (1024
clients, 8 ES, duty-cycled availability), and the mesh-scale
``metropolis-100k`` (32 ES) and ``metropolis-1m`` (64 ES).
``flash-crowd`` discounts a permuted cohort's prices during periodic
surges.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

from repro_torch.configs.paper_hfl import (BURSTY_1K, METROPOLIS_1K,
                                           METROPOLIS_1M, METROPOLIS_100K,
                                           MNIST_CONVEX, HFLExperimentConfig)
from repro_torch.core.network import _dbm_to_watt, context_rate_hi
from repro_torch.envs.scenarios import SCENARIOS, ScenarioSpec, tier_edges
from repro_torch.sim.faults import FaultSpec


@dataclass(frozen=True)
class SimSpec:
    """Everything static about one simulated network."""
    num_clients: int
    num_edge_servers: int
    update_bits: float
    workload: float
    deadline_s: float
    tx_w: float                 # transmit power, watts
    noise_psd_w: float          # thermal noise PSD, watts/Hz
    cell_radius_km: float
    area: float                 # half-width of the bounding box, km
    rate_hi: float              # context normalization (host float64)
    price_low: float
    price_high: float
    bandwidth_low: float
    bandwidth_high: float
    compute_low: float
    compute_high: float
    mobility: float
    jitter: float
    price_tier_values: Optional[Tuple[float, ...]] = None
    price_tier_edges: Optional[Tuple[float, ...]] = None
    surge_period: int = 0       # flash-crowd surges (0 disables)
    surge_len: int = 10
    surge_count: int = 0        # clients in the surge cohort
    surge_discount: float = 0.3
    arrival_period: int = 0
    arrival_len: int = 1
    # the ground-truth participation probability: "mc" (the mean over
    # mc_true_p fading pairs) or "analytic" (the exact Eq. 6 integral,
    # sim.truep; no fading-pair draws)
    true_p: str = "mc"
    mc_true_p: int = 128
    # optional fault injection (sim.faults); None or all-zero rates draw
    # nothing
    faults: Optional[FaultSpec] = None

    def min_cost(self) -> float:
        """Analytic lower bound on any realized per-client cost:
        2 * price * bandwidth / 1e6 at the cheapest price and
        bandwidth_low, times the flash-crowd discount."""
        price = (min(self.price_tier_values) if self.price_tier_values
                 else self.price_low)
        cost = 2.0 * price * self.bandwidth_low / 1e6
        if self.surge_period > 0:
            cost *= self.surge_discount
        return cost

    @classmethod
    def from_env(cls, cfg: HFLExperimentConfig, scen: ScenarioSpec,
                 mc_true_p: int = 128, true_p: str = "mc",
                 faults: Optional[FaultSpec] = None) -> "SimSpec":
        """The spec of ``cfg`` under ``scen``. ``true_p`` is ``"mc"``
        (the Monte-Carlo estimate over ``mc_true_p`` fading pairs) or
        ``"analytic"`` (the Eq. 6 integral, ``sim.truep``); ``faults``
        an optional ``sim.faults.FaultSpec``."""
        if true_p not in ("mc", "analytic"):
            raise ValueError(f"unknown true_p mode {true_p!r}")
        tiers = scen.price_tiers
        return cls(
            num_clients=cfg.num_clients,
            num_edge_servers=cfg.num_edge_servers,
            update_bits=cfg.update_bits, workload=cfg.workload,
            deadline_s=cfg.deadline_s,
            tx_w=_dbm_to_watt(cfg.tx_power_dbm),
            noise_psd_w=_dbm_to_watt(cfg.noise_dbm_per_hz),
            cell_radius_km=cfg.cell_radius_km,
            area=1.5 + cfg.cell_radius_km, rate_hi=context_rate_hi(cfg),
            price_low=cfg.price_low, price_high=cfg.price_high,
            bandwidth_low=cfg.bandwidth_low,
            bandwidth_high=cfg.bandwidth_high,
            compute_low=cfg.compute_low, compute_high=cfg.compute_high,
            mobility=scen.mobility, jitter=scen.jitter,
            price_tier_values=(tuple(float(p) for p, _ in tiers)
                               if tiers else None),
            price_tier_edges=(tuple(float(e) for e in tier_edges(tiers))
                              if tiers else None),
            surge_period=scen.surge_period, surge_len=scen.surge_len,
            surge_count=(max(1, int(round(scen.surge_frac
                                          * cfg.num_clients)))
                         if scen.surge_period > 0 else 0),
            surge_discount=scen.surge_discount,
            arrival_period=scen.arrival_period,
            arrival_len=(max(1, int(round(scen.arrival_duty
                                          * scen.arrival_period)))
                         if scen.arrival_period > 0 else 1),
            true_p=true_p, mc_true_p=mc_true_p, faults=faults)


METROPOLIS_SCEN = ScenarioSpec(name="metropolis-1k", mobility=0.3,
                               jitter=0.4)
BURSTY_SCEN = ScenarioSpec(name="bursty-arrival", mobility=0.2, jitter=0.3,
                           arrival_period=40, arrival_duty=0.35)
# the mesh-scale cohorts (``repro_torch.mesh``): duty-cycled arrival
# waves, so only a fraction of the metropolis is reachable a round
METROPOLIS_100K_SCEN = ScenarioSpec(name="metropolis-100k", mobility=0.3,
                                    jitter=0.4, arrival_period=50,
                                    arrival_duty=0.3)
METROPOLIS_1M_SCEN = ScenarioSpec(name="metropolis-1m", mobility=0.3,
                                  jitter=0.4, arrival_period=80,
                                  arrival_duty=0.25)

PRESETS: Dict[str, Tuple[HFLExperimentConfig, ScenarioSpec]] = {
    **{name: (MNIST_CONVEX, scen) for name, scen in SCENARIOS.items()},
    "metropolis-1k": (METROPOLIS_1K, METROPOLIS_SCEN),
    "bursty-arrival": (BURSTY_1K, BURSTY_SCEN),
    "metropolis-100k": (METROPOLIS_100K, METROPOLIS_100K_SCEN),
    "metropolis-1m": (METROPOLIS_1M, METROPOLIS_1M_SCEN),
}


def preset(name: str) -> Tuple[HFLExperimentConfig, ScenarioSpec]:
    key = name.lower()
    if key not in PRESETS:
        raise KeyError(f"unknown sim preset {name!r}; available: "
                       f"{tuple(sorted(PRESETS))}")
    return PRESETS[key]


class DeviceEnv(NamedTuple):
    """A named device environment: its config, scenario and spec."""
    cfg: HFLExperimentConfig
    scenario: ScenarioSpec
    spec: SimSpec

    def rollout(self, seed: int, horizon: int, device=None) -> list:
        """``horizon`` rounds of one seed as host ``RoundData`` (float32
        values), realized by the device simulator on ``device``
        (``None`` means CUDA, as every entry point of the port): the
        path of host-state policies on a device env, as the reference's
        ``DeviceEnv.rollout``."""
        import torch

        from repro_torch.core.network import RoundData
        from repro_torch.kernels.common import resolve_device
        from repro_torch.sim.core import init_statics, sim_round
        seed_t = torch.as_tensor([int(seed)], dtype=torch.int64,
                                 device=resolve_device(device))
        statics = init_statics(self.spec, seed_t)
        pos, out = statics.pos0, []
        for t in range(int(horizon)):
            pos, sr = sim_round(self.spec, seed_t, statics, pos, t)
            rd = {k: v[0].cpu().numpy() for k, v in sr.round._asdict().items()}
            out.append(RoundData(
                t=int(rd["t"]), contexts=rd["contexts"],
                eligible=rd["eligible"], costs=rd["costs"],
                outcomes=rd["outcomes"], true_p=rd["true_p"],
                compute=sr.compute[0].cpu().numpy(),
                bandwidth=sr.bandwidth[0].cpu().numpy(),
                latency=rd["latency"]))
        return out


def make(name: str = "paper", cfg: Optional[HFLExperimentConfig] = None,
         mc_true_p: int = 128, true_p: str = "mc",
         faults: Optional[FaultSpec] = None) -> DeviceEnv:
    """A preset's device environment; ``cfg`` replaces its experiment
    config (``make("paper", CIFAR10_NONCONVEX)``), ``true_p`` picks
    the participation estimator (``"mc"`` or ``"analytic"``) and
    ``faults`` injects the ``FaultSpec``'s faults, as the reference's
    ``sim.make``."""
    pcfg, scen = preset(name)
    cfg = pcfg if cfg is None else cfg
    return DeviceEnv(cfg, scen, SimSpec.from_env(cfg, scen, mc_true_p,
                                                 true_p, faults))


def resolve(env):
    """A string selector -> an env object, as the reference's
    ``sim.resolve``: ``"device"`` / ``"device:<preset>"`` -> the device
    env (``make``); ``"host:<scenario>"`` or a bare scenario name -> the
    host env (``envs.make``), except a preset that exists only on the
    device (``metropolis-1k``, ``bursty-arrival``), which resolves to
    the device env. Non-strings (``HFLEnv``, ``DeviceEnv``) pass
    through."""
    if not isinstance(env, str):
        return env
    key = env.lower()
    if key == "device":
        return make("paper")
    if key.startswith("device:"):
        return make(key.split(":", 1)[1])
    from repro_torch import envs
    if key.startswith("host:"):
        key = key.split(":", 1)[1]
    if key in PRESETS and key not in envs.SCENARIOS:
        return make(key)               # device-only presets
    return envs.make(key)
