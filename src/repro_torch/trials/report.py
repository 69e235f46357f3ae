"""Markdown reports over suite results and the persisted ledger (the
reference's ``trials/report.py``, the same markdown).

``suite_report`` renders one run: policy rows x config-coordinate
columns, each cell showing regret-vs-oracle, cumulative utility, final
accuracy (when the suite trains) and wall-clock. ``ledger_report``
renders the persisted trajectory for a suite label: the same cells plus
the merge-time annotations (``speedup_vs``, ``metric_deltas``) that
track how quality and cost moved since the previous recorded run.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Optional, Tuple

from repro_torch.trials.ledger import suite_entries, timing
from repro_torch.trials.metrics import TrialRecord


def _coord_label(coord) -> str:
    if not coord:
        return "—"
    return ", ".join(f"{a}={v}" for a, v in coord)


def _fmt_cell(regret: Optional[float], cum: Optional[float],
              acc: Optional[float], us: Optional[float]) -> str:
    parts = []
    if regret is not None:
        parts.append(f"regret {regret:.0f}")
    if cum is not None:
        parts.append(f"u {cum:.0f}")
    if acc is not None:
        parts.append(f"acc {acc:.3f}")
    if us is not None:
        parts.append(f"{us / 1e6:.2f}s")
    return " · ".join(parts) if parts else "—"


def suite_report(result) -> str:
    """One suite run as a markdown table (policy rows x coord columns)."""
    records: List[TrialRecord] = result.records
    policies = list(dict.fromkeys(r.policy for r in records))
    coords = list(dict.fromkeys(r.coord for r in records))
    by_key = {(r.policy, r.coord): r for r in records}

    lines = [f"# Trial suite `{result.label}`", ""]
    if result.suite.description:
        lines += [result.suite.description, ""]
    lines += [f"- git rev: `{result.git_rev}` · draw schedule: "
              f"`{result.draw_schedule}` · total "
              f"{result.total_us / 1e6:.1f}s",
              f"- regret reference: `{result.suite.oracle}` "
              "(same draw schedule)", ""]
    header = ["policy"] + [_coord_label(c) for c in coords]
    lines.append("| " + " | ".join(header) + " |")
    lines.append("|" + "---|" * len(header))
    for policy in policies:
        row = [policy]
        for coord in coords:
            rec = by_key.get((policy, coord))
            row.append("—" if rec is None else _fmt_cell(
                rec.regret, rec.cum_utility, rec.final_acc,
                rec.us_per_call))
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines) + "\n"


def _entry_row(entry: Mapping[str, Any]) -> Tuple[str, str, str]:
    m = entry.get("metrics") or {}
    cell = _fmt_cell(m.get("regret"), m.get("cum_utility"),
                     m.get("final_acc"), timing(entry))
    trend = []
    if entry.get("speedup_vs") is not None:
        trend.append(f"{entry['speedup_vs']:.2f}x speed")
    for key, delta in (entry.get("metric_deltas") or {}).items():
        if key.endswith("_seeds") or key == "acc_curve":
            continue
        if delta:
            trend.append(f"{key} {delta:+g}")
    return (str(entry.get("policy", entry["name"])), cell,
            ", ".join(trend) if trend else "steady")


def ledger_report(entries: Mapping[str, Any], suite_label: str) -> str:
    """The persisted trajectory of one suite label as markdown."""
    sub = suite_entries(entries, suite_label)
    lines = [f"# Ledger trajectory · `{suite_label}`", ""]
    if not sub:
        lines.append("_no ledger entries for this suite label_")
        return "\n".join(lines) + "\n"
    lines.append("| cell | latest | vs previous run |")
    lines.append("|---|---|---|")
    for name, entry in sub.items():
        policy, cell, trend = _entry_row(entry)
        coord = entry.get("coord") or {}
        label = policy + ("" if not coord else
                          " (" + ", ".join(f"{k}={v}"
                                           for k, v in coord.items()) + ")")
        lines.append(f"| {label} | {cell} | {trend} |")
    rev = next((e.get("provenance", {}).get("git_rev")
                for e in sub.values() if e.get("provenance")), None)
    if rev:
        lines += ["", f"last recorded at git rev `{rev}`"]
    return "\n".join(lines) + "\n"


__all__ = ["ledger_report", "suite_report"]
