#!/usr/bin/env python3
"""The non-convex path's test loss and accuracy over rounds on the card:
``sweep_experiments`` on ``paper`` under ``CIFAR10_NONCONVEX`` with the
CNN at 32x32x3, TF32 off.

    PYTHONPATH=src python3 tools/nonconvex_losses.py first   # on the card
    PYTHONPATH=src python3 tools/nonconvex_losses.py trend

    PYTHONPATH=src python3 tools/nonconvex_losses.py cpu

``first``: the three policies, 2 seeds, 30 rounds at lr 0.005 (an eval
every 3) and 10 at the configuration's lr 0.1 (every 2), with launch
counts, walk host syncs and peak memory; then 2 rounds of COCS, seed 0,
on the CPU and on CUDA (wall and losses). ``trend``: COCS, 4 seeds, 60
rounds at lr 0.005 with an eval every round; then the three policies, 2
seeds, 60 rounds, an eval every 5. Prints losses and accuracies by eval.
``cpu``: one round of the three policies at lr 0.005 for each of seeds
0-3 on the CPU and twice on CUDA, cuDNN's nondeterministic algorithms
allowed and then not: each run's count of correctly classified test
samples (of 2000), the loss gap, and whether the two CUDA runs agree.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "..", "src"))


def cpu_against_cuda(env, data, dev, pols) -> int:
    from repro_torch.experiment.sweep import sweep_experiments
    n_test = len(data.test_y)
    kw = dict(horizon=1, eval_every=1, model_kind="cnn", data=data)
    correct = lambda r, p: int(round(float(r.accuracy[p][0, 0]) * n_test))
    for seed in range(4):
        cpu = sweep_experiments(pols, env, seeds=(seed,), device="cpu",
                                **kw)
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            a, b = (sweep_experiments(pols, env, seeds=(seed,), device=dev,
                                      **kw) for _ in range(2))
            for p in pols:
                gap = abs(float(cpu.loss[p][0, 0]) - float(a.loss[p][0, 0]))
                print(f"seed {seed} {p} cudnn.deterministic={det}: "
                      f"correct CPU {correct(cpu, p)}, CUDA "
                      f"{correct(a, p)} and {correct(b, p)} of {n_test}; "
                      f"loss gap {gap:.3e}; CUDA runs equal "
                      f"{bool(a.loss[p][0, 0] == b.loss[p][0, 0])}",
                      flush=True)
    torch.backends.cudnn.deterministic = False
    return 0


def main() -> int:
    from repro_torch.configs.paper_hfl import CIFAR10_NONCONVEX
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.experiment.sweep import sweep_experiments
    from repro_torch.kernels import _build, common
    from repro_torch.kernels.budgeted_topk.ops import WALK_SYNCS
    from repro_torch.sim import spec as tspec
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = sys.argv[1] if len(sys.argv) > 1 else "first"
    _build.build_all()
    dev = torch.device("cuda", 0)
    data = FederatedDataset.synthetic(50, kind="cifar", seed=0)
    env = lambda lr: tspec.make("paper", dataclasses.replace(
        CIFAR10_NONCONVEX, lr=lr))
    pols = ("cocs", "oracle", "random")
    if mode == "cpu":
        return cpu_against_cuda(env(0.005), data, dev, pols)
    runs = {"first": ((pols, (0, 1), 0.005, 30, 3),
                      (pols, (0, 1), 0.1, 10, 2)),
            "trend": ((("cocs",), (0, 1, 2, 3), 0.005, 60, 1),
                      (pols, (0, 1), 0.005, 60, 5))}[mode]
    for names, seeds, lr, horizon, every in runs:
        common.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = sweep_experiments(names, env(lr), seeds=seeds, horizon=horizon,
                              eval_every=every, model_kind="cnn",
                              data=data, device=dev)
        torch.cuda.synchronize()
        print(f"lr {lr}, {horizon} rounds: wall "
              f"{time.perf_counter() - t0:.1f} s; launches "
              f"{common.LAUNCHES}; syncs {WALK_SYNCS}; peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        for p in names:
            print(f"  {p} loss {r.loss[p].tolist()}")
            print(f"  {p} mean loss {r.loss[p].mean(0).tolist()}")
            print(f"  {p} acc {r.accuracy[p].tolist()}", flush=True)
    if mode == "first":
        for d in ("cpu", dev):
            t0 = time.perf_counter()
            r = sweep_experiments(("cocs",), env(0.005), seeds=(0,),
                                  horizon=2, eval_every=1, model_kind="cnn",
                                  data=data, device=d)
            print(f"2 rounds of cocs on {d}: "
                  f"{time.perf_counter() - t0:.1f} s; loss "
                  f"{r.loss['cocs'].tolist()}; accuracy "
                  f"{r.accuracy['cocs'].tolist()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
