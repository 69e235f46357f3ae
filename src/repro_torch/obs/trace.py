"""Host span tracer: a JSONL event log of a run's lifecycle (the
reference's ``obs/trace.py``, record for record).

One JSON object a line:

    {"ev": "span",  "name": "fused_block", "ts": ..., "dur_us": ...,
     "pid": ..., "tid": ..., ...attrs}
    {"ev": "event", "name": "health",      "ts": ..., ...attrs}

after a ``{"ev": "begin", "name": "repro-trace/v1", ...}`` header, the
reference's schema, so either package's report reads either package's
trace. ``ts`` is microseconds of ``time.perf_counter_ns`` (only deltas
within one log mean anything); the header also has a ``wall`` ISO
timestamp. ``export_perfetto`` renders the log as Chrome ``trace_event``
JSON for chrome://tracing and ui.perfetto.dev.

A tracer is installed explicitly (``configure``, ``trace_to``,
``run_tracing``) or, for zero-code capture of an entry point, from the
environment:

    REPRO_TORCH_TRACE=run.jsonl REPRO_TORCH_TRACE_PERFETTO=run.trace.json \\
        python3 chip_smoke.py

(names of the port's own, so a process that imports both packages never
opens the reference's tracer and this one from one variable).
Instrumentation calls ``span``/``event`` unconditionally; with no tracer
they cost one check.
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional

_SCHEMA = "repro-trace/v1"
ENV_TRACE = "REPRO_TORCH_TRACE"
ENV_PERFETTO = "REPRO_TORCH_TRACE_PERFETTO"


def now_us() -> int:
    """Monotonic microsecond clock (the timestamps in trace records)."""
    return time.perf_counter_ns() // 1000


class Tracer:
    """Appends span and event records to a JSONL file, thread-safely."""

    def __init__(self, path: str, perfetto: Optional[str] = None):
        self.path = path
        self.perfetto = perfetto
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._write({"ev": "begin", "name": _SCHEMA, "ts": now_us(),
                     "wall": datetime.datetime.now(datetime.timezone.utc)
                     .isoformat()})

    def _write(self, rec: Dict[str, Any]) -> None:
        line = json.dumps(rec, default=_jsonable)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def event(self, name: str, **attrs: Any) -> None:
        self._write({"ev": "event", "name": name, "ts": now_us(),
                     "pid": self._pid,
                     "tid": threading.get_ident() & 0xFFFF, **attrs})

    def span_record(self, name: str, ts: int, dur_us: int,
                    attrs: Dict[str, Any]) -> None:
        self._write({"ev": "span", "name": name, "ts": ts,
                     "dur_us": dur_us, "pid": self._pid,
                     "tid": threading.get_ident() & 0xFFFF, **attrs})

    def close(self) -> None:
        with self._lock:
            if self._f.closed:
                return
            self._f.close()
        if self.perfetto:
            export_perfetto(self.path, self.perfetto)


def _jsonable(x: Any) -> Any:
    # numpy scalars and arrays and tensors reach the tracer from attrs;
    # duck-typed so the module imports neither
    if hasattr(x, "item") and getattr(x, "ndim", None) in (0, None):
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return str(x)


# -- global activation -------------------------------------------------------

_TRACER: Optional[Tracer] = None
_ENV_CHECKED = False


def active() -> Optional[Tracer]:
    """The current tracer, if any. The first call honours
    ``REPRO_TORCH_TRACE``."""
    global _TRACER, _ENV_CHECKED
    if _TRACER is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        path = os.environ.get(ENV_TRACE)
        if path:
            _TRACER = Tracer(path, os.environ.get(ENV_PERFETTO) or None)
            atexit.register(_close_global)
    return _TRACER


def _close_global() -> None:
    global _TRACER
    if _TRACER is not None:
        _TRACER.close()
        _TRACER = None


def configure(path: Optional[str],
              perfetto: Optional[str] = None) -> Optional[Tracer]:
    """Install (or, with ``path=None``, remove) the global tracer."""
    global _TRACER
    _close_global()
    if path is not None:
        _TRACER = Tracer(path, perfetto)
    return _TRACER


@contextlib.contextmanager
def trace_to(path: str, perfetto: Optional[str] = None) -> Iterator[Tracer]:
    """Trace the enclosed block to ``path``, then restore the previous
    tracer."""
    global _TRACER
    prev = _TRACER
    _TRACER = Tracer(path, perfetto)
    try:
        yield _TRACER
    finally:
        _TRACER.close()
        _TRACER = prev


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Dict[str, Any]]:
    """Time the enclosed block. Yields the attrs dict so the body can
    attach results before the record is written; no record without a
    tracer."""
    tr = active()
    if tr is None:
        yield attrs
        return
    t0 = now_us()
    try:
        yield attrs
    finally:
        tr.span_record(name, t0, now_us() - t0, attrs)


def event(name: str, **attrs: Any) -> None:
    """Emit an instant event; nothing without a tracer."""
    tr = active()
    if tr is not None:
        tr.event(name, **attrs)


@contextlib.contextmanager
def _torch_profile(directory: str) -> Iterator[None]:
    """A ``torch.profiler`` capture of the enclosed block (CPU, and CUDA
    where a device exists) written as Chrome trace JSON into
    ``directory``: the port's reading of ``ObsSpec.jax_profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        directory, f"repro_torch.{os.getpid()}.{now_us()}.trace.json"))


@contextlib.contextmanager
def run_tracing(obs_spec) -> Iterator[None]:
    """Scope a run's tracing to its ``ObsSpec``: the JSONL trace, its
    Perfetto export on close, and a ``torch.profiler`` capture into
    ``jax_profiler`` (the field keeps the reference's name so specs
    round-trip)."""
    with contextlib.ExitStack() as stack:
        if getattr(obs_spec, "jax_profiler", None):
            stack.enter_context(_torch_profile(obs_spec.jax_profiler))
        if getattr(obs_spec, "trace", None):
            stack.enter_context(trace_to(obs_spec.trace, obs_spec.perfetto))
        yield


# -- Perfetto / Chrome trace_event export -------------------------------------


def export_perfetto(jsonl_path: str, out_path: str) -> int:
    """Render a JSONL trace as Chrome ``trace_event`` JSON. Returns the
    number of trace events written."""
    events = []
    with open(jsonl_path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{jsonl_path}:{lineno}: not a repro JSONL trace "
                    f"(expected one JSON object per line: {e})") from e
            if not isinstance(rec, dict):
                raise ValueError(
                    f"{jsonl_path}:{lineno}: not a repro JSONL trace "
                    f"(line decodes to {type(rec).__name__})")
            ev = rec.get("ev")
            common = {"name": rec.get("name", "?"),
                      "pid": rec.get("pid", 0), "tid": rec.get("tid", 0),
                      "ts": rec.get("ts", 0)}
            args = {k: v for k, v in rec.items()
                    if k not in ("ev", "name", "ts", "dur_us", "pid", "tid")}
            if ev == "span":
                events.append({**common, "ph": "X",
                               "dur": rec.get("dur_us", 0), "args": args})
            elif ev == "event":
                events.append({**common, "ph": "i", "s": "t", "args": args})
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


__all__ = ["Tracer", "active", "configure", "trace_to", "span", "event",
           "run_tracing", "export_perfetto", "now_us"]
