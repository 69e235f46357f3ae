"""``repro_torch.obs``: observability of the port's training tiers (the
reference's ``repro.obs``).

* the host span tracer: ``span``/``event``/``trace_to`` write a JSONL log
  of a run (a Perfetto export; a ``torch.profiler`` capture on request);
* the device taps: ``ObsSpec(telemetry=True)`` carries per-round metrics
  and running totals through the tier-3 and tier-4 blocks into
  ``RunResult.telemetry`` (``obs.telemetry``);
* the run profile: ``python -m repro_torch.obs report run.jsonl``.

The eager surface (spec, tracer, logging) imports neither torch nor
numpy; ``telemetry`` and ``report`` load on first use.
"""
from repro_torch.obs import logging_setup
from repro_torch.obs.spec import ObsSpec
from repro_torch.obs.trace import (Tracer, active, configure, event,
                                   export_perfetto, run_tracing, span,
                                   trace_to)

_LAZY = ("telemetry", "report")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return importlib.import_module(f"repro_torch.obs.{name}")
    raise AttributeError(
        f"module 'repro_torch.obs' has no attribute {name!r}")


__all__ = ["ObsSpec", "Tracer", "active", "configure", "event",
           "export_perfetto", "run_tracing", "span", "trace_to",
           "logging_setup", "telemetry", "report"]
