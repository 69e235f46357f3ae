"""Where a round's time goes under faults: ``chip_smoke.py``'s phase-17
workload (``repro_torch.run`` tier 4, metropolis-1k, logreg, 2 seeds, 50
samples a client) without faults, under ``FAULT_RATES`` with ``mean``,
and under ``FAULT_RATES`` with ``median``.

    python3 tools/faults_profile.py [--rounds N]      # on the GPU

Builds the kernels and prints the card's name and power limit. For each
case, in the order clean, faulty, faulty median, median, faulty, clean:
the wall per round over ``--rounds`` rounds (default 20) after a warm-up
run. Then for each case, five rounds under torch.profiler: host ms a
round by stage (the ``round.*`` labels), summed kernel time and kernel
launches a round, and the device's busy share (kernel time over the
unprofiled wall). The last line is one JSON object of these numbers.
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

CASES = {"clean": ("mean", None), "faulty": ("mean", "all"),
         "faulty-median": ("median", "all")}
PROFILE_ROUNDS = 5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("faults_profile: no CUDA device", file=sys.stderr)
        return 2
    from dataclasses import replace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import repro_torch
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda", 0)
    data = FederatedDataset.synthetic(1000, kind="mnist",
                                      samples_per_client=50, seed=0)
    data.stacked(dev)
    specs = {k: replace(chip_smoke.fault_spec("logreg", rule, faults),
                        horizon=args.rounds)
             for k, (rule, faults) in CASES.items()}

    def run(spec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        repro_torch.run(spec, data=data, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for spec in specs.values():
        run(spec)
    walls = {k: [] for k in specs}
    for k in ("clean", "faulty", "faulty-median", "faulty-median", "faulty",
              "clean"):
        walls[k].append(run(specs[k]) / args.rounds)
    out = {}
    for k, spec in specs.items():
        round_s = sum(walls[k]) / len(walls[k])
        short = replace(spec, horizon=PROFILE_ROUNDS,
                        eval=replace(spec.eval, eval_every=PROFILE_ROUNDS))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(short)
        rows = chip_smoke.kernel_rows(prof)
        kernel_ms = sum(e.self_device_time_total for e in rows) / 1e3 \
            / PROFILE_ROUNDS
        launches = sum(e.count for e in rows) / PROFILE_ROUNDS
        stages = {e.key: e.cpu_time_total / 1e3 / PROFILE_ROUNDS
                  for e in prof.key_averages()
                  if e.key.startswith("round.")
                  and e.device_type == DeviceType.CPU}
        out[k] = dict(round_ms=[w * 1e3 for w in walls[k]],
                      stages_host_ms=stages, kernel_ms=kernel_ms,
                      kernels_a_round=launches,
                      busy=kernel_ms / (round_s * 1e3))
        print(f"{k}: {[round(w * 1e3, 3) for w in walls[k]]} ms a round "
              f"unprofiled; kernels {kernel_ms:.3f} ms and {launches:.0f} "
              f"launches a round, busy {out[k]['busy']:.3f}; host ms a "
              f"round: " + ", ".join(f"{s} {v:.3f}" for s, v in
                                     sorted(stages.items())))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
