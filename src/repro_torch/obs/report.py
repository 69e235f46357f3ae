"""A markdown run profile from a JSONL trace (the reference's
``obs/report.py``): phase times by span name, the training blocks'
dispatch and execute split, the health guard's findings and, where the
run had its taps on, each policy's telemetry profile from the
``telemetry`` events ``repro_torch.run`` writes.

The port compiles nothing: it has no jit compiles and no compiled-block
factory, so the reference's counts of those print as not applicable.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List


def load_trace(path: str) -> List[Dict[str, Any]]:
    recs = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: not a repro JSONL trace "
                    f"(expected one JSON object per line: {e})") from e
            if not isinstance(rec, dict):
                raise ValueError(
                    f"{path}:{lineno}: not a repro JSONL trace "
                    f"(line decodes to {type(rec).__name__}, not an object)")
            recs.append(rec)
    return recs


def _ms(us: float) -> str:
    return f"{us / 1000.0:.1f}"


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _sparkline(xs: List[float]) -> str:
    """A compact unicode trace of a series (at most 40 bucket means)."""
    if not xs:
        return ""
    bars = "▁▂▃▄▅▆▇█"
    n = min(len(xs), 40)
    step = len(xs) / n
    vals = []
    for i in range(n):
        chunk = xs[int(i * step):max(int(i * step) + 1, int((i + 1) * step))]
        vals.append(sum(chunk) / max(1, len(chunk)))
    lo, hi = min(vals), max(vals)
    width = (hi - lo) or 1.0
    return "".join(bars[int((v - lo) / width * (len(bars) - 1))]
                   for v in vals)


def render_report(path: str) -> str:
    recs = load_trace(path)
    spans = [r for r in recs if r.get("ev") == "span"]
    events = [r for r in recs if r.get("ev") == "event"]
    begin = next((r for r in recs if r.get("ev") == "begin"), None)

    lines = ["# Run profile", "",
             f"Trace: `{path}` — {len(spans)} spans, "
             f"{len(events)} events"
             + (f", started {begin['wall']}" if begin and "wall" in begin
                else ""), ""]

    by_name: Dict[str, List[float]] = defaultdict(list)
    for s in spans:
        by_name[s.get("name", "?")].append(float(s.get("dur_us", 0)))
    total = sum(sum(v) for v in by_name.values()) or 1.0
    lines += ["## Phase times", "",
              "| phase | calls | total ms | share |",
              "|---|---:|---:|---:|"]
    for name, durs in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
        lines.append(f"| {name} | {len(durs)} | {_ms(sum(durs))} "
                     f"| {sum(durs) / total:.1%} |")
    lines.append("")

    blocks = [s for s in spans if s.get("name") in
              ("fused_block", "fused_block_device")]
    if blocks:
        disp = sum(float(b.get("dispatch_us", 0)) for b in blocks)
        execute = sum(float(b.get("execute_us", 0)) for b in blocks)
        block_total = sum(float(b.get("dur_us", 0)) for b in blocks) or 1.0
        lines += ["## Fused blocks", "",
                  f"- {len(blocks)} block dispatches; jit compiles and "
                  "factory-cache hits: not applicable (nothing is "
                  "compiled)",
                  f"- dispatch (host) {_ms(disp)} ms vs execute (waiting "
                  f"on the device) {_ms(execute)} ms — dispatch share "
                  f"{disp / block_total:.1%} of block time", ""]

    health = [e for e in events if e.get("name") == "health"]
    if health:
        lines += ["## Health events", ""]
        for h in health:
            lines.append(f"- interval {h.get('interval')} "
                         f"(round {h.get('round_end')}): "
                         f"{', '.join(h.get('bad', []))}")
        lines.append("")

    tele = [e for e in events if e.get("name") == "telemetry"]
    for t in tele:
        lines += [f"## Telemetry — {t.get('policy', '?')}", ""]
        summary = t.get("summary", {})
        if summary:
            lines += ["| metric | value |", "|---|---:|"]
            lines += [f"| {k} | {_fmt(v)} |"
                      for k, v in sorted(summary.items())]
            lines.append("")
        for key, label in (("participation", "participation / round"),
                           ("explored", "exploration"),
                           ("ucb_width", "UCB width")):
            xs = t.get(key)
            if xs:
                lines.append(f"- {label}: `{_sparkline(xs)}` "
                             f"({_fmt(xs[0])} → {_fmt(xs[-1])})")
        lines.append("")

    if not blocks and not tele and not health:
        lines.append("_No fused-block spans or telemetry events in this "
                     "trace — was the run instrumented?_")
    return "\n".join(lines).rstrip() + "\n"


__all__ = ["load_trace", "render_report"]
