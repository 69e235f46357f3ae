"""``python -m repro_torch.trials``: run, gate, and report trial suites
(the reference's trial CLI, plus ``--device`` on ``run``).

    python -m repro_torch.trials list
    python -m repro_torch.trials run paper-fig3 --ledger build/trials.json
    python -m repro_torch.trials run paper-fig4-quick --smoke \\
        --ledger build/trials.json --report --device cpu
    python -m repro_torch.trials check --baseline base.json \\
        --current build/trials.json --suite paper-fig4-quick@smoke
    python -m repro_torch.trials report --ledger build/trials.json \\
        --suite paper-fig3

``run`` runs on CUDA unless given ``--device cpu``. ``check`` exits
non-zero on any suite-wide regression against the baseline ledger and
skips cleanly when the baseline has no entries for the suite label.

All subcommands take the shared ``-v``/``--quiet`` logging flags
(``repro_torch.obs.logging_setup``); default stdout is what ``print``
would give. ``run`` also writes per-dispatch progress lines with an ETA
to **stderr** (the ``repro_torch.progress`` logger), so piped stdout
never sees them.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.obs.logging_setup import (add_logging_args, get_logger,
                                     setup_from_args)


def _cmd_list(_args) -> int:
    from repro_torch.trials import suites  # noqa: F401 — registration
    from repro_torch.trials.suite import SUITES
    log = get_logger("repro_torch.trials")
    for name in sorted(SUITES):
        suite = SUITES[name]
        n_cells = len(suite.policies) * max(
            1, len(tuple(suite.coords())))
        log.info(f"{name}: {n_cells} cells "
                 f"({len(suite.policies)} policies"
                 + (f" x {dict(suite.axes)}" if suite.axes else "")
                 + f"), oracle={suite.oracle}")
        if suite.description:
            log.info(f"    {suite.description}")
    return 0


def _cmd_run(args) -> int:
    from repro_torch.trials.report import suite_report
    from repro_torch.trials.runner import run_suite

    log = get_logger("repro_torch.trials")
    result = run_suite(args.suite, smoke=args.smoke, ledger=args.ledger,
                       resume=args.resume, device=args.device)
    if args.report:
        log.info(suite_report(result))
    else:
        for rec in result.records:
            us = "-" if rec.us_per_call is None \
                else f"{rec.us_per_call / 1e6:.2f}s"
            extra = "" if rec.regret is None \
                else f" regret={rec.regret:.1f}"
            acc = "" if rec.final_acc is None \
                else f" final_acc={rec.final_acc:.3f}"
            log.info(f"{rec.name}: cum_utility={rec.cum_utility:.1f}"
                     f"{extra}{acc} [{us}]")
    if args.ledger:
        log.info(f"ledger: appended {len(result.records)} records to "
                 f"{args.ledger}")
    return 0


def _cmd_check(args) -> int:
    from repro_torch.trials.ledger import check_suite, load_entries

    log = get_logger("repro_torch.trials")
    baseline = load_entries(args.baseline)
    current = load_entries(args.current)
    failures = 0
    for label in args.suite:
        n, report = check_suite(
            baseline, current, label, acc_atol=args.acc_atol,
            max_time_ratio=args.max_time_ratio,
            time_reference=args.time_reference)
        for line in report:
            (log.warning if line.endswith("FAIL") else log.info)(line)
        failures += n
    return 1 if failures else 0


def _cmd_report(args) -> int:
    from repro_torch.trials.ledger import load_entries
    from repro_torch.trials.report import ledger_report

    log = get_logger("repro_torch.trials")
    entries = load_entries(args.ledger)
    for label in args.suite:
        log.info(ledger_report(entries, label))
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.trials",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    sub.add_parser("list", help="registered suites").set_defaults(
        fn=_cmd_list)

    p_run = sub.add_parser("run", help="run a suite (optionally append "
                                       "to a ledger)")
    p_run.add_argument("suite", help="registered suite name")
    p_run.add_argument("--smoke", action="store_true",
                       help="tiny-horizon CI variant (records under "
                            "<name>@smoke)")
    p_run.add_argument("--ledger", default=None, metavar="PATH",
                       help="append records to this BENCH_*-compatible "
                            "JSON store")
    p_run.add_argument("--report", action="store_true",
                       help="print the markdown suite report")
    p_run.add_argument("--resume", action="store_true",
                       help="skip cells already recorded in --ledger "
                            "with the identical resolved spec "
                            "(git-rev-agnostic); requires --ledger")
    p_run.add_argument("--device", default=None,
                       help="torch device of every cell (default: CUDA; "
                            "'cpu' for the plain PyTorch path)")
    p_run.set_defaults(fn=_cmd_run)

    p_check = sub.add_parser("check", help="suite-wide baseline "
                                           "regression gate")
    p_check.add_argument("--baseline", required=True)
    p_check.add_argument("--current", required=True)
    p_check.add_argument("--suite", action="append", required=True,
                         help="suite label(s) to gate, e.g. paper-fig3 "
                              "or paper-fig4-quick@smoke (repeatable)")
    p_check.add_argument("--acc-atol", type=float, default=0.02)
    p_check.add_argument("--max-time-ratio", type=float, default=None)
    p_check.add_argument("--time-reference", default=None,
                         help="normalize timings by this entry within "
                              "each file before the ratio guard")
    p_check.set_defaults(fn=_cmd_check)

    p_rep = sub.add_parser("report", help="markdown trajectory report "
                                          "from a ledger")
    p_rep.add_argument("--ledger", required=True)
    p_rep.add_argument("--suite", action="append", required=True)
    p_rep.set_defaults(fn=_cmd_report)

    add_logging_args(ap)
    args = ap.parse_args(argv)
    setup_from_args(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
