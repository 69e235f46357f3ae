#!/usr/bin/env python3
"""Reference caveat R11 on the sweep: the reference's and the port's
``sweep_experiments(("cocs",), <paper with CIFAR10_NONCONVEX>, seeds=(0,),
horizon=5, model_kind="cnn")`` at the ``cifar_small`` (16, 16, 3) shape,
on the CPU, each with its own init, an eval after every round; prints
both test losses and accuracies eval by eval, at the configuration's
lr = 0.1 and at lr = 0.005.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/r11_sweep.py

Takes a few minutes (the reference runs its CNN under XLA on the CPU).
It imports both packages, as the parity tests do; it is not part of the
port.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


def main() -> None:
    from repro import sim as jsim
    from repro.configs.paper_hfl import CIFAR10_NONCONVEX as JCFG
    from repro.data.federated import FederatedDataset as JData
    from repro.experiment.sweep import sweep_experiments as jax_sweep
    from repro_torch.configs.paper_hfl import CIFAR10_NONCONVEX as TCFG
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.experiment.sweep import sweep_experiments
    from repro_torch.sim import spec as tspec

    kw = dict(seeds=(0,), horizon=5, eval_every=1, model_kind="cnn")
    for lr in (0.1, 0.005):
        jd = JData.synthetic(50, kind="cifar_small", seed=0)
        td = FederatedDataset.synthetic(50, kind="cifar_small", seed=0)
        t0 = time.perf_counter()
        want = jax_sweep(("cocs",), jsim.make(
            "paper", dataclasses.replace(JCFG, lr=lr)), data=jd, **kw)
        t1 = time.perf_counter()
        got = sweep_experiments(("cocs",), tspec.make(
            "paper", dataclasses.replace(TCFG, lr=lr)), data=td,
            device="cpu", **kw)
        t2 = time.perf_counter()
        same = np.array_equal(np.asarray(want.selections["cocs"]),
                              got.selections["cocs"])
        print(f"lr = {lr}: selections bitwise {same} (reference "
              f"{t1 - t0:.0f} s, port {t2 - t1:.0f} s on the CPU)")
        for name, r in (("reference", want), ("port", got)):
            loss = np.asarray(r.loss["cocs"])[0]
            acc = np.asarray(r.accuracy["cocs"])[0]
            print(f"  {name:9s} test loss by eval "
                  f"{[float(x) for x in loss]}")
            print(f"  {name:9s} accuracy by eval  "
                  f"{[float(x) for x in acc]}")


if __name__ == "__main__":
    main()
