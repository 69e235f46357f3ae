#!/usr/bin/env python3
"""``chip_smoke.device_ms`` through torch.profiler against its CUDA-event
fallback, on a few calls of different sizes, cold (L2 flushed) and warm.
The fallback is forced by replacing ``torch.profiler.profile`` with one
whose traces hold no device time; the script fails unless every call
took the route it was meant to.

    python3 tools/device_ms_fallback.py          # on the card
"""
from __future__ import annotations

import os
import sys

import torch
import torch.profiler

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


class EmptyProfile:
    """A profiler whose trace holds no event."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return []


def main() -> int:
    if not torch.cuda.is_available():
        print("device_ms_fallback: needs a CUDA device", file=sys.stderr)
        return 2
    x = torch.randn(1 << 20, device="cuda")
    y = torch.randn(16 << 20, device="cuda")
    a = torch.randn(2048, 2048, device="cuda")
    calls = {"mul_ 4 MB": lambda: x.mul_(1.0),
             "mul_ 64 MB": lambda: y.mul_(1.0),
             "_sleep(0)": lambda: torch.cuda._sleep(0),
             "matmul 2048": lambda: a @ a,
             "three launches": lambda: (x.mul_(1.0), x.add_(0.0),
                                        x.mul_(1.0))}
    prof = {k: (cs.device_ms(f), cs.device_ms(f, cold=False))
            for k, f in calls.items()}
    torch.profiler.profile = EmptyProfile
    ev = {k: (cs.device_ms(f), cs.device_ms(f, cold=False))
          for k, f in calls.items()}
    for k in calls:
        print(f"{k}: profiler cold {prof[k][0] * 1e3:.3f} warm "
              f"{prof[k][1] * 1e3:.3f} us; events cold {ev[k][0] * 1e3:.3f} "
              f"warm {ev[k][1] * 1e3:.3f} us")
    print(f"device times taken with {cs.TIMED_WITH}")
    n = len(calls) * 2
    if cs.TIMED_WITH != {"profiler": n, "events": n}:
        print(f"device_ms_fallback: expected {n} of each route",
              file=sys.stderr)
        return 1
    if not all(v > 0 for pair in ev.values() for v in pair):
        print("device_ms_fallback: an event time is not positive",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
