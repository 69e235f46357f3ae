"""The bandit tier on one card: ``chip_smoke.py``'s phase 15 alone, with
its profile, then both ``true_p`` modes timed in turns.

    python3 tools/bandit_tier.py [--rounds N]      # on the GPU

Builds the kernels, prints the card's name and power limit, runs
``chip_smoke.bandit_tier(dev, profile=True)`` (every check of phase 15:
paper-fig3's three policies through ``repro_torch.run`` at metropolis-1k
in both ``true_p`` modes, the budget grid, the CPU against CUDA, tier 4
against ``sweep_experiments``; ``round.env`` and ``round.select`` host
ms a round for COCS in each mode), then times COCS over ``--rounds``
rounds (default 100) in the order analytic, mc, mc, analytic and prints
rounds per second of each run. Exits non-zero where a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=100)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bandit_tier: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import repro_torch
    from repro_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    out = chip_smoke.bandit_tier(dev, profile=True)
    turns = []
    for mode in ("analytic", "mc", "mc", "analytic"):
        spec = chip_smoke.bandit_spec("cocs", mode, args.rounds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        repro_torch.run(spec, device=dev)
        torch.cuda.synchronize()
        rps = args.rounds / (time.perf_counter() - t0)
        turns.append([mode, rps])
        print(f"cocs {mode}: {args.rounds} rounds at {rps:.3f} rounds/s")
    out["turns"] = turns
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
