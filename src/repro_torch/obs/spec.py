"""``ObsSpec``: how a run is observed (a copy of the reference's
``obs/spec.py``, :40-66), so that a spec reads and writes the same JSON
on either package.

``telemetry`` turns on the on-device metric taps of tiers 3 and 4
(``obs.telemetry``, ``RunResult.telemetry``), ``trace`` names a JSONL
span log (``obs.trace``), ``perfetto`` its Chrome-trace export, and
``jax_profiler`` (the reference's name, kept so specs round-trip) a
directory that receives a ``torch.profiler`` trace of the run. All
default off.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional


@dataclass(frozen=True)
class ObsSpec:
    """Observability knobs for one run (all off by default)."""
    telemetry: bool = False              # on-device metric taps
    trace: Optional[str] = None          # JSONL span/event log path
    perfetto: Optional[str] = None       # Chrome trace_event export path
    jax_profiler: Optional[str] = None   # torch.profiler trace dir

    def __post_init__(self):
        if self.perfetto is not None and self.trace is None:
            raise ValueError("ObsSpec.perfetto requires ObsSpec.trace: "
                             "the export is rendered from the JSONL log")

    @property
    def enabled(self) -> bool:
        return bool(self.telemetry or self.trace or self.jax_profiler)

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ObsSpec":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"ObsSpec: unknown field(s) "
                             f"{sorted(unknown)}; expected {sorted(names)}")
        return cls(**dict(d))
