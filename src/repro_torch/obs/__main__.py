"""``python -m repro_torch.obs {report,export} TRACE.jsonl``."""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.logging_setup import (add_logging_args, get_logger,
                                           setup_from_args)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect JSONL run traces")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_rep = sub.add_parser("report", help="render a markdown run profile")
    p_rep.add_argument("trace", help="JSONL trace path (REPRO_TORCH_TRACE)")
    p_rep.add_argument("-o", "--out", default=None,
                       help="write the report here instead of stdout")
    add_logging_args(p_rep)

    p_exp = sub.add_parser("export",
                           help="export a Chrome/Perfetto trace_event file")
    p_exp.add_argument("trace", help="JSONL trace path")
    p_exp.add_argument("-o", "--out", required=True,
                       help="output .trace.json path")
    add_logging_args(p_exp)

    args = parser.parse_args(argv)
    setup_from_args(args)
    log = get_logger("repro_torch.obs")
    try:
        if args.cmd == "report":
            from repro_torch.obs.report import render_report
            text = render_report(args.trace)
            if args.out:
                with open(args.out, "w", encoding="utf-8") as f:
                    f.write(text)
                log.info("wrote %s", args.out)
            else:
                sys.stdout.write(text)
            return 0
        from repro_torch.obs.trace import export_perfetto
        n = export_perfetto(args.trace, args.out)
        log.info("wrote %s (%d trace events)", args.out, n)
        return 0
    except (OSError, ValueError) as e:
        log.error("error: %s", e)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
