"""``FaultSpec``: the description of the four fault processes of the
reference's ``sim/faults.py`` (:53-94), so that a spec that names faults
reads and writes the same JSON on either package.

Only the frozen dataclass is ported: its fields, defaults, validation,
``enabled`` and the dict round trip. Injecting the faults (client
dropout, straggler inflation, ES outages, update corruption, draw tags
7-11) is not: ``repro_torch.run`` refuses a spec whose faults are
enabled (ROADMAP queue A item 3).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping

_RATES = ("dropout_rate", "straggler_rate", "outage_rate", "corrupt_rate")


@dataclass(frozen=True)
class FaultSpec:
    """Per-round event probabilities in [0, 1]; a rate of 0 disables
    that process."""
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
