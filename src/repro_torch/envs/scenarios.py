"""Scenario presets for the HFL network environment (a copy of the
reference's ``envs/scenarios.py``).

  * ``paper``          — Table I as-is (random-waypoint mobility, jittered
                         per-round resources, uniform pricing).
  * ``static-clients`` — no mobility, near-constant resources: the
                         stationary regime.
  * ``high-mobility``  — fast random waypoint + strong resource jitter:
                         eligibility churns every round.
  * ``tiered-pricing`` — discrete price tiers (budget/mid/premium clients)
                         instead of U[0.5, 2].
  * ``flash-crowd``    — every ``surge_period`` rounds a surge cohort's
                         rental cost collapses for ``surge_len`` rounds.
  * bursty arrival     — ``arrival_period > 0`` staggers clients into
                         periodic availability windows (duty-cycled
                         eligibility).

All scenario randomness (tier membership, surge cohort, arrival phases)
comes from the shared counter-based draw schedule (``sim.draws``), so
the device simulator (``sim.core``) realizes the same scenarios.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.paper_hfl import HFLExperimentConfig
from repro_torch.core.network import HFLNetworkSim, RoundData


@dataclass(frozen=True)
class ScenarioSpec:
    name: str = "paper"
    mobility: float = 0.15
    jitter: float = 0.30
    # ((price, weight), ...) — draw each client's price from discrete tiers
    price_tiers: Optional[Tuple[Tuple[float, float], ...]] = None
    # flash-crowd pricing surges (surge_period == 0 disables)
    surge_period: int = 0
    surge_len: int = 10
    surge_frac: float = 0.3
    surge_discount: float = 0.3
    # bursty arrival: available during a window of arrival_duty *
    # arrival_period rounds at a per-client phase (0 disables)
    arrival_period: int = 0
    arrival_duty: float = 0.5


SCENARIOS: Dict[str, ScenarioSpec] = {
    "paper": ScenarioSpec(name="paper"),
    "static-clients": ScenarioSpec(name="static-clients", mobility=0.0,
                                   jitter=0.05),
    "high-mobility": ScenarioSpec(name="high-mobility", mobility=0.6,
                                  jitter=0.5),
    "tiered-pricing": ScenarioSpec(
        name="tiered-pricing",
        price_tiers=((0.5, 0.5), (1.0, 0.3), (2.0, 0.2))),
    "flash-crowd": ScenarioSpec(name="flash-crowd", surge_period=50),
}


def tier_edges(price_tiers) -> np.ndarray:
    """Cumulative tier probabilities as float32 (the comparison values
    the device sim uses, so tier membership matches bitwise)."""
    w = np.array([w for _, w in price_tiers], np.float64)
    return (np.cumsum(w) / w.sum()).astype(np.float32)


def tiered_prices(price_tiers, price_u: np.ndarray) -> np.ndarray:
    """Map the shared U[0,1) price draw onto discrete tier prices."""
    values = np.array([p for p, _ in price_tiers], np.float64)
    idx = np.searchsorted(tier_edges(price_tiers),
                          np.asarray(price_u, np.float32), side="right")
    return values[np.minimum(idx, len(values) - 1)]


def arrival_phases(phase_u: np.ndarray, period: int) -> np.ndarray:
    """Per-client integer arrival phase in [0, period). The product
    floors in float32, as the device sim computes it: a float64 product
    can land just below an integer that the float32 one rounds up to."""
    prod = np.asarray(phase_u, np.float32) * np.float32(period)
    return np.minimum(prod.astype(np.int64), period - 1)


class ScenarioSim(HFLNetworkSim):
    """HFLNetworkSim with scenario knobs applied."""

    def __init__(self, cfg: HFLExperimentConfig, spec: ScenarioSpec,
                 seed: int = 0, **kw):
        super().__init__(cfg, seed=seed, mobility=spec.mobility,
                         jitter=spec.jitter, **kw)
        self.spec = spec
        n = cfg.num_clients
        di = self.init_draws
        if spec.price_tiers is not None:
            self.price = tiered_prices(spec.price_tiers, di.price_u)
        if spec.surge_period > 0:
            k = max(1, int(round(spec.surge_frac * n)))
            self.surge_cohort = np.asarray(di.perm[:k])
        if spec.arrival_period > 0:
            self.arrival_phase = arrival_phases(di.phase_u,
                                                spec.arrival_period)
            self.arrival_len = max(1, int(round(spec.arrival_duty
                                                * spec.arrival_period)))

    def round(self, t: int) -> RoundData:
        rd = super().round(t)
        s = self.spec
        if s.surge_period > 0 and (t % s.surge_period) < s.surge_len:
            rd.costs = rd.costs.copy()
            rd.costs[self.surge_cohort] *= s.surge_discount
        if s.arrival_period > 0:
            active = ((t - self.arrival_phase) % s.arrival_period
                      < self.arrival_len)
            rd.eligible = rd.eligible & active[:, None]
        return rd
