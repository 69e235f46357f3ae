"""Training launcher, the counterpart of the reference's
``launch/train.py``.

    python -m repro_torch.launch.train --paper --rounds 10 --eval-every 5
    python -m repro_torch.launch.train --paper --rounds 4 --device cpu

``--paper`` runs the paper's HFL experiment (N=50 clients, M=3 ESs, COCS
in the loop, logreg under ``MNIST_CONVEX``; ``--nonconvex`` the CNN
under ``CIFAR10_NONCONVEX`` at its configured lr 0.1) as one
``repro_torch.run`` of tier 3, on the reference's seed-keyed synthetic
data, and prints the test accuracy at each eval. It runs on CUDA unless
given ``--device cpu``. ``--arch`` (LM-scale HFL training) is not
ported yet and raises ``NotImplementedError``; the reference's flags of
that mode (``--clients``, ``--seq-len``, ``--batch``, ``--lr``,
``--scenario``) come with it.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs.paper_hfl import CIFAR10_NONCONVEX, MNIST_CONVEX


def run_paper(args) -> int:
    from repro_torch import api
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.kernels.common import resolve_device

    dev = resolve_device(args.device)
    exp = CIFAR10_NONCONVEX if args.nonconvex else MNIST_CONVEX
    spec = api.ExperimentSpec(
        policy=api.PolicySpec("cocs", options=(("h_t", exp.h_t),)),
        env=api.env_spec_from_config(exp),
        train=api.TrainSpec(model="cnn" if args.nonconvex else "logreg"),
        eval=api.EvalSpec(args.eval_every),
        horizon=args.rounds, seeds=(args.seed,))
    # seed-keyed synthetic data, as the reference's launcher makes it
    data = FederatedDataset.synthetic(
        exp.num_clients, kind="cifar" if args.nonconvex else "mnist",
        seed=args.seed)
    res = api.run(spec, data=data, device=dev)
    for r, a in zip(res.eval_rounds, res.accuracy[0]):
        print(f"round {int(r):4d}  test_acc {a:.4f}", flush=True)
    print(f"final accuracy: {res.accuracy[0][-1]:.4f}")
    return 0


def run_lm(args) -> int:
    from repro_torch.api.run import _not_ported
    raise _not_ported(f"LM-scale HFL training (--arch {args.arch})", 5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--paper", action="store_true")
    ap.add_argument("--nonconvex", action="store_true")
    ap.add_argument("--arch", metavar="ID",
                    help="LM-scale HFL training (not ported yet)")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' for the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.paper:
        return run_paper(args)
    if args.arch:
        return run_lm(args)
    ap.error("choose --paper or --arch <id>")
    return 2


if __name__ == "__main__":
    sys.exit(main())
