"""Fault injection for the HFL network simulators: ``FaultSpec``, the
four fault processes of the reference's ``sim/faults.py``, and the
functions that apply them.

Every fault event is drawn from the counter-based schedule
(``sim.draws.fault_draws``, tags 7-11 keyed by ``(seed, t)``) and
thresholded as ``float32(u) < float32(rate)``: the float64 host env
(``core.network``, numpy) downcasts its float64 view of the float32
draws first, so both envs see the same events. With a ``FaultSpec`` off
(``None`` or all rates 0) no fault stream is drawn and no other stream
moves.

  * **dropout**: a hit client's Eq. 5 latency is +inf this round (it
    misses every deadline).
  * **straggler**: a hit client's latency is multiplied by
    ``1 + straggler_scale * Exp(1)``. Applied before dropout.
  * **outage**: a hit edge server's eligibility column is cleared (a
    client covered only by it has an empty row).
  * **corruption**: a hit client's model delta is scaled by
    ``corrupt_scale`` before the Eq. 3 aggregation; consumed by the
    training round (``fed.batched``), not by the simulators.

Each function takes torch tensors (the device env and the training
round, with leading batch axes) or numpy arrays (the host env); the
event masks are float32 comparisons on both, the magnitudes are
computed in the caller's dtype. On torch float32 the straggler factor is
one fused multiply-add, as the reference's under ``jit``
(``core.fmath``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.fmath import fma

_RATES = ("dropout_rate", "straggler_rate", "outage_rate", "corrupt_rate")


@dataclass(frozen=True)
class FaultSpec:
    """Per-round event probabilities in [0, 1]; a rate of 0 disables
    that process (its draws are never made)."""
    dropout_rate: float = 0.0      # P[client contributes nothing]
    straggler_rate: float = 0.0    # P[client latency inflated]
    straggler_scale: float = 4.0   # latency factor = 1 + scale * Exp(1)
    outage_rate: float = 0.0       # P[edge server down for the round]
    corrupt_rate: float = 0.0      # P[client update corrupted]
    corrupt_scale: float = -10.0   # delta multiplier on corrupted updates

    def __post_init__(self):
        for name in _RATES:
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultSpec.{name} must be in [0, 1], "
                                 f"got {v!r}")
        if self.straggler_scale < 0.0:
            raise ValueError("FaultSpec.straggler_scale must be >= 0, "
                             f"got {self.straggler_scale!r}")

    @property
    def enabled(self) -> bool:
        return any(getattr(self, name) > 0.0 for name in _RATES)

    @property
    def env_fields(self) -> tuple:
        """The ``FaultDraws`` fields the simulators draw for this spec."""
        out = ()
        if self.dropout_rate > 0.0:
            out += ("drop_u",)
        if self.straggler_rate > 0.0:
            out += ("strag_u", "strag_e")
        if self.outage_rate > 0.0:
            out += ("out_u",)
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultSpec":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"FaultSpec: unknown field(s) "
                             f"{sorted(unknown)}; expected {sorted(names)}")
        return cls(**{k: float(v) for k, v in d.items()})


def _hit(u, rate: float):
    """The float32 event threshold: ``float32(u) < float32(rate)``."""
    r = np.float32(rate)
    if isinstance(u, torch.Tensor):
        return u.to(torch.float32) < float(r)   # r is exact in float32
    return np.asarray(u, np.float32) < r


def apply_latency_faults(spec: FaultSpec, tau, strag_u, strag_e, drop_u):
    """Straggler inflation, then dropout, on the Eq. 5 latencies ``tau``
    (..., N, M): float32 tensors or float64 numpy arrays; the per-client
    vectors (..., N) broadcast over the ES axis."""
    torch_form = isinstance(tau, torch.Tensor)
    where = torch.where if torch_form else np.where
    if spec.straggler_rate > 0.0:
        hit = _hit(strag_u, spec.straggler_rate)
        if torch_form:          # the device env's float32
            factor = fma(spec.straggler_scale, strag_e, 1.0)
        else:
            factor = 1.0 + spec.straggler_scale * np.asarray(strag_e,
                                                             tau.dtype)
        tau = where(hit[..., None], tau * factor[..., None], tau)
    if spec.dropout_rate > 0.0:
        hit = _hit(drop_u, spec.dropout_rate)
        inf = (torch.full_like(tau, torch.inf) if torch_form
               else np.asarray(np.inf, tau.dtype))
        tau = where(hit[..., None], inf, tau)
    return tau


def apply_outage(spec: FaultSpec, eligible, out_u):
    """Clear the eligibility column (..., N, M) of every ES in outage."""
    if spec.outage_rate <= 0.0:
        return eligible
    down = _hit(out_u, spec.outage_rate)
    return eligible & ~down[..., None, :]


def corrupt_mask(spec: FaultSpec, corr_u):
    """(..., N) bool: which clients' updates are corrupted this round."""
    if spec.corrupt_rate <= 0.0:
        if isinstance(corr_u, torch.Tensor):
            return torch.zeros(corr_u.shape, dtype=torch.bool,
                               device=corr_u.device)
        return np.zeros(np.shape(corr_u), bool)
    return _hit(corr_u, spec.corrupt_rate)


__all__ = ["FaultSpec", "apply_latency_faults", "apply_outage",
           "corrupt_mask"]
