"""Rounds per second of the HFL main path for one or more checkouts, in
turns on one card: the way to compare a change with its parent.

    python3 tools/hfl_rounds.py [ROOT ...]        # on the GPU

Each ROOT is the root of a checkout (default: this one); give the parent
and the change in turns (parent, change, change, parent), since host
speed moves between runs. For each ROOT, in the order given, a fresh
process imports ``ROOT/src``'s ``repro_torch``, builds its kernels into
``ROOT/build``, runs the main path once for 2 rounds (warm-up), then
times ``sweep_experiments(("cocs",), "device:metropolis-1k", seeds=(0,
1), horizon=20, eval_every=5)`` on CUDA with 200 synthetic samples a
client (``chip_smoke.py``'s phase 4) and prints one line: the root,
rounds per second, the walk's host syncs, the final accuracy per seed
and a digest of every round's selections (equal digests, equal
selections).
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

RUN = r'''
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.data.federated import FederatedDataset
from repro_torch.experiment.sweep import sweep_experiments
from repro_torch.kernels.budgeted_topk import ops as topk_ops
from repro_torch.sim import spec as simspec
dev = torch.device("cuda", 0)
env = simspec.make("metropolis-1k")
data = FederatedDataset.synthetic(env.cfg.num_clients, kind="mnist",
                                  samples_per_client=200, seed=0)
data.stacked(dev)
kw = dict(seeds=(0, 1), eval_every=5, data=data, device=dev)
sweep_experiments(("cocs",), "device:metropolis-1k", horizon=2, **kw)
torch.cuda.synchronize()
topk_ops.WALK_SYNCS["greedy_walk"] = 0
t0 = time.perf_counter()
res = sweep_experiments(("cocs",), "device:metropolis-1k", horizon=20, **kw)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
print(json.dumps({"rounds_per_s": 20 / wall,
                  "walk_syncs": topk_ops.WALK_SYNCS["greedy_walk"],
                  "accuracy": res.accuracy["cocs"][:, -1].tolist(),
                  "selections": hashlib.sha256(
                      res.selections["cocs"].tobytes()).hexdigest()[:16]}))
'''


def main() -> None:
    roots = [Path(a).resolve() for a in sys.argv[1:]] or [
        Path(__file__).resolve().parent.parent]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    for root in roots:
        out = subprocess.run([sys.executable, "-c", RUN, str(root)],
                             capture_output=True, text=True, cwd=root)
        if out.returncode:
            sys.exit(f"hfl_rounds: {root} failed:\n{out.stderr[-3000:]}")
        print(f"{root}: {out.stdout.strip().splitlines()[-1]}")


if __name__ == "__main__":
    main()
