"""The sharded cohort with a card a rank, against the dense run on one
card: what a pick of the sharded walk costs when ranks do not share a
card, over gloo (collectives staged through the host) and over NCCL.

    python3 tools/mesh_cards.py           # on a host with 4 GPUs

Runs ``chip_smoke.py`` phase 20's metropolis-100k spec (COCS, analytic,
batch 16, an eval every 2 rounds, 4 rounds, seeds 0 and 1, the 16-d tiny
data) once dense on ``cuda:0``, then with ``ShardSpec(clients=4)`` on 4
ranks started by ``launch.mesh.spawn_local``, rank r on ``cuda:r``,
first over gloo and then over NCCL. For each layout it checks every field
of every rank bitwise against the dense run (exit 1 otherwise) and prints
one line: rounds/s, the ranks' run seconds, peak GB a rank, the walk's
host syncs and collectives a round and ms a pick. The last line is the
JSON of all of it with the cards' names and power limits.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ROUNDS = 4
FIELDS = ("selections", "utilities", "participants", "explored",
          "accuracy", "loss")
DATA = dict(num_clients=100_000, kind="tiny", samples_per_client=20,
            seed=0)


def spec(shard=None):
    from repro_torch import api
    return api.ExperimentSpec(
        policy=api.PolicySpec("cocs"),
        env=api.EnvSpec("metropolis-100k", true_p="analytic"),
        train=api.TrainSpec(batch_size=16), eval=api.EvalSpec(eval_every=2),
        horizon=ROUNDS, seeds=(0, 1), shard=shard)


def main() -> int:
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import api
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.launch.mesh import run_specs, spawn_local

    if torch.cuda.device_count() < 4:
        print("mesh_cards: needs 4 CUDA devices", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cards = smi.stdout.strip().splitlines()
    dev = torch.device("cuda", 0)
    data = FederatedDataset.synthetic(**DATA)
    repro_torch.run(spec(), data=data, device=dev)          # warm-up
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    dense = repro_torch.run(spec(), data=data, device=dev)
    torch.cuda.synchronize(dev)
    out = {"cards": cards, "dense_rounds_per_s":
           ROUNDS / (time.perf_counter() - t0)}
    print(f"dense on cuda:0: {out['dense_rounds_per_s']:.3f} rounds/s")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for backend in ("gloo", "nccl"):
            ranks = spawn_local(
                run_specs, 4, backend=backend, device="cuda",
                init_file=os.path.join(tmp, f"rdv-{backend}"),
                args=([spec(api.ShardSpec(clients=4)).to_json()] * 2,
                      DATA), timeout=900.0)
            for r, rows in enumerate(ranks):
                for f in FIELDS:
                    if not np.array_equal(np.asarray(getattr(dense, f)),
                                          rows[1][f]):
                        print(f"mesh_cards: {backend} rank {r} {f} differs "
                              "from the dense run", file=sys.stderr)
                        return 1
            r0 = ranks[0][1]                    # the second run: warm
            secs = max(rk[1]["seconds"] for rk in ranks)
            picks = r0["walk_syncs"]
            row = dict(rounds_per_s=ROUNDS / secs,
                       run_s=[rk[1]["seconds"] for rk in ranks],
                       peak_gb=[rk[1]["peak_bytes"] / 1e9 for rk in ranks],
                       walk_syncs_a_round=picks / ROUNDS,
                       collectives_a_round={k: v / ROUNDS for k, v in
                                            r0["collectives"].items()},
                       ms_a_pick=secs * 1e3 / max(picks, 1))
            out[backend] = row
            print(f"4 ranks, a card each, over {backend}: every field "
                  f"bitwise the dense run; {row['rounds_per_s']:.3f} "
                  f"rounds/s, {row['ms_a_pick']:.3f} ms a pick, runs "
                  f"{[round(x, 3) for x in row['run_s']]} s, peak GB "
                  f"{[round(x, 3) for x in row['peak_gb']]}, collectives "
                  f"a round {row['collectives_a_round']}")
    for card in cards:
        print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
