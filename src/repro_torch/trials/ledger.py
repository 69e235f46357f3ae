"""The perf/quality ledger in the ``BENCH_*.json`` entry format (a copy
of the reference's ``trials/ledger.py``; a ledger written by either
package is read, merged, gated and resumed by the other).

An entry is a JSON object with at least ``name``, ``us_per_call`` and
``derived``. ``us_per_call`` is ``None`` for timing-less records:
every timing consumer goes through :func:`timing`, which maps
``None``/``0``/garbage to "no measurement" instead of dividing by it.
Trial records also carry ``suite`` (which suite and variant produced
them), ``metrics`` (typed quality numbers) and ``provenance`` (resolved
spec, tier, draw-schedule id, git rev).

``merge_entries`` merges by name with trajectory annotations
(``speedup_vs``, ``metric_deltas``) and an atomic write;
``append_suite`` records a suite run; ``check_suite`` gates a suite run
against a baseline ledger.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

Entry = Dict[str, Any]


# -- timing normalization ----------------------------------------------------


def timing(entry: Optional[Mapping[str, Any]]) -> Optional[float]:
    """The entry's measured ``us_per_call`` as a positive float, or None
    for timing-less/absent/errored records. The single place that
    decides what counts as a usable measurement — both the regression
    guard and the speedup annotations route through it, so a
    ``us_per_call: null`` (or legacy ``0.0``) derived-only row can never
    reach a division."""
    if not entry:
        return None
    try:
        us = float(entry.get("us_per_call"))
    except (TypeError, ValueError):
        return None
    return us if us > 0 else None


def entry_metric(entries: Mapping[str, Entry], name: str,
                 reference: Optional[str] = None) -> Optional[float]:
    """``us_per_call`` of ``name``, divided by ``reference``'s within the
    same file when given (the hardware-independent ``NAME:REF`` guard
    quantity). None when any needed row carries no usable timing."""
    value = timing(entries.get(name))
    if value is None:
        return None
    if reference:
        ref = timing(entries.get(reference))
        if ref is None:
            return None
        value /= ref
    return value


# -- store I/O ---------------------------------------------------------------


def load_entries(path: str) -> Dict[str, Entry]:
    """name -> entry from a ``BENCH_*.json`` list, insertion-ordered;
    empty on a missing or corrupt file."""
    try:
        with open(path) as f:
            return {e["name"]: e for e in json.load(f)}
    except (OSError, json.JSONDecodeError, KeyError, TypeError):
        return {}


def rows_to_entries(rows: Iterable[Tuple[str, Optional[float], str]]
                    ) -> List[Entry]:
    """Benchmark CSV rows ``(name, us_per_call | None, derived)`` as
    ledger entries."""
    return [{"name": name, "us_per_call": us, "derived": derived}
            for name, us, derived in rows]


def merge_entries(new_entries: Iterable[Entry], path: str) -> List[Entry]:
    """Merge entries by name into the JSON list at ``path``.

    Entries from earlier runs/subsets accumulate in first-seen order. A
    re-measured *timed* entry gains ``speedup_vs`` (previous / new
    ``us_per_call``; >1 means faster than the last committed run);
    timing-less records never get one. A re-recorded entry whose old and
    new versions both carry a ``metrics`` dict gains ``metric_deltas``
    (new - old per shared numeric metric) — the quality trajectory that
    parallels the timing one. Returns the merged list (also written to
    ``path``).

    The write is atomic (temp file in the target directory +
    ``os.replace``): a run killed mid-write — exactly the fault mode the
    resilient runner is built for — leaves the previous ledger intact
    instead of a truncated JSON that ``load_entries`` silently reads as
    empty.
    """
    previous = load_entries(path)
    order: List[str] = list(previous)
    merged: Dict[str, Entry] = dict(previous)
    for entry in new_entries:
        entry = dict(entry)
        name = entry["name"]
        old = merged.get(name)
        t_old, t_new = timing(old), timing(entry)
        if t_old is not None and t_new is not None:
            entry["speedup_vs"] = round(t_old / t_new, 3)
        if (old and isinstance(old.get("metrics"), Mapping)
                and isinstance(entry.get("metrics"), Mapping)):
            deltas = {
                k: round(v - old["metrics"][k], 6)
                for k, v in entry["metrics"].items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
                and isinstance(old["metrics"].get(k), (int, float))
                and not isinstance(old["metrics"].get(k), bool)}
            if deltas:
                entry["metric_deltas"] = deltas
        if name not in merged:
            order.append(name)
        merged[name] = entry
    out = [merged[n] for n in order]
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return out


def git_rev(default: str = "unknown") -> str:
    """Short git revision of the repo this module lives in (provenance
    for ledger records); ``default`` when git is unavailable."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, cwd=root,
                             timeout=10)
    except (OSError, subprocess.SubprocessError):
        return default
    rev = out.stdout.strip()
    return rev if out.returncode == 0 and rev else default


# -- suite records -----------------------------------------------------------


def append_suite(result, path: str) -> List[Entry]:
    """Append a ``SuiteResult``'s records to the ledger at ``path``
    (merge by name: a re-run suite *replaces* its cells and gains
    trajectory annotations). Returns the suite's merged entries."""
    entries = [rec.to_entry() for rec in result.records]
    merged = merge_entries(entries, path)
    names = {e["name"] for e in entries}
    return [e for e in merged if e["name"] in names]


def suite_entries(entries: Mapping[str, Entry],
                  suite_label: str) -> Dict[str, Entry]:
    """The subset of ledger entries recorded by one suite run variant
    (``suite`` field == label, e.g. ``paper-fig3`` or
    ``paper-fig4-quick@smoke``)."""
    return {n: e for n, e in entries.items()
            if e.get("suite") == suite_label}


def _close(a: float, b: float, rtol: float, atol: float) -> bool:
    return abs(a - b) <= atol + rtol * abs(b)


def check_suite(baseline: Mapping[str, Entry],
                current: Mapping[str, Entry], suite_label: str, *,
                utility_rtol: float = 1e-6, utility_atol: float = 1e-4,
                acc_atol: float = 0.02,
                max_time_ratio: Optional[float] = None,
                time_reference: Optional[str] = None
                ) -> Tuple[int, List[str]]:
    """Suite-wide baseline gate. Returns (failures, report).

    For every record of ``suite_label`` in ``baseline``:

      * no baseline entries for ``suite_label`` -> skip cleanly (a new
        suite has no trajectory to regress);
      * a baseline cell missing from the current run -> FAIL (the suite
        stopped measuring it);
      * quality metrics (``cum_utility``, ``regret``, ``participation``)
        must match the baseline to ``utility_rtol`` — they are
        draw-schedule-deterministic, so a repeat run on any machine
        reproduces them exactly and *any* drift is a behavior change;
      * ``final_acc`` is float-training output, allowed ``acc_atol``;
      * timings are only guarded when ``max_time_ratio`` is given, as
        ``cell / time_reference`` within each file (machine cancels);
        timing-less cells skip.
    """
    base = suite_entries(baseline, suite_label)
    cur = suite_entries(current, suite_label)
    report: List[str] = []
    if not base:
        report.append(f"{suite_label}: no committed baseline entries — "
                      "skipping")
        return 0, report
    failures = 0
    exact = {"cum_utility": (utility_rtol, utility_atol),
             "regret": (utility_rtol, utility_atol),
             "participation": (utility_rtol, utility_atol)}
    for name, b in base.items():
        c = cur.get(name)
        if c is None:
            report.append(f"{name}: missing from current run — FAIL")
            failures += 1
            continue
        bm = b.get("metrics") or {}
        cm = c.get("metrics") or {}
        bad = []
        for key, (rtol, atol) in exact.items():
            if isinstance(bm.get(key), (int, float)):
                if not isinstance(cm.get(key), (int, float)):
                    bad.append(f"{key} missing")
                elif not _close(float(cm[key]), float(bm[key]), rtol, atol):
                    bad.append(f"{key} {bm[key]:g} -> {cm[key]:g}")
        if isinstance(bm.get("final_acc"), (int, float)):
            if not isinstance(cm.get("final_acc"), (int, float)):
                bad.append("final_acc missing")
            elif abs(float(cm["final_acc"]) - float(bm["final_acc"])) \
                    > acc_atol:
                bad.append(f"final_acc {bm['final_acc']:g} -> "
                           f"{cm['final_acc']:g} (atol {acc_atol:g})")
        if max_time_ratio is not None:
            bt = entry_metric(baseline, name, time_reference)
            ct = entry_metric(current, name, time_reference)
            if bt is not None and ct is not None \
                    and ct / bt > max_time_ratio:
                bad.append(f"time {bt:.3g} -> {ct:.3g} "
                           f"({ct / bt:.2f}x > {max_time_ratio:.2f}x)")
        if bad:
            report.append(f"{name}: " + "; ".join(bad) + " — FAIL")
            failures += 1
        else:
            report.append(f"{name}: OK")
    extra = sorted(set(cur) - set(base))
    for name in extra:
        report.append(f"{name}: new entry (no baseline) — recorded")
    return failures, report


__all__ = [
    "Entry", "append_suite", "check_suite", "entry_metric", "git_rev",
    "load_entries", "merge_entries", "rows_to_entries", "suite_entries",
    "timing",
]
