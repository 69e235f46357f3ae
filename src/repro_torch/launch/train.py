"""Training launcher, the counterpart of the reference's
``launch/train.py``.

    python -m repro_torch.launch.train --paper --rounds 10 --eval-every 5
    python -m repro_torch.launch.train --arch qwen2-1.5b --rounds 3 --device cpu

Two modes, on CUDA unless given ``--device cpu``:

  * ``--paper``: the paper's HFL experiment (N=50 clients, M=3 ESs, COCS
    in the loop, logreg under ``MNIST_CONVEX``; ``--nonconvex`` the CNN
    under ``CIFAR10_NONCONVEX`` at its configured lr 0.1) as one
    ``repro_torch.run`` of tier 3, on the reference's seed-keyed
    synthetic data; it prints the test accuracy at each eval.
  * ``--arch <id>``: LM-scale HFL training of the arch's ``reduced()``
    variant (``lm_rounds``): each round COCS selects clients on the host
    sim of ``--scenario`` (``--clients`` of them, the ``MNIST_CONVEX``
    settings), each selected client's next token batch (``--batch`` x
    ``--seq-len`` from its Zipf shard) takes one SGD step
    (``fed.distributed.make_train_step``, ``--lr``) with its Eq. 6
    outcome as the per-example weight. It prints the reference's lines:
    round 1 and every 10th, the clients selected and their mean loss.
    ``audio`` and ``vlm`` archs also take frame or patch embeddings, N(0,
    1) in the model dtype from a generator seeded with ``--seed`` (the
    reference's launcher passes the token batch alone, which those archs'
    losses cannot take).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

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


def lm_rounds(cfg, params: dict, clients: int = 16, rounds: int = 100,
              seq_len: int = 128, batch: int = 4, lr: float = 1e-3,
              scenario: str = "paper", seed: int = 0, device=None,
              verbose: bool = True
              ) -> Tuple[dict, List[Tuple[np.ndarray, List[float]]]]:
    """The reference's ``run_lm`` loop from given ``params`` (on
    ``device``): ``rounds`` rounds of COCS (``policies.make_legacy``, one
    seed on ``device``) over ``envs.make(scenario, ...).make_sim(seed)``,
    one ``make_train_step`` a selected client. Returns the final params
    and each round's (selected clients, their losses in order)."""
    from repro_torch import envs, policies
    from repro_torch.data.tokens import client_token_shards
    from repro_torch.fed.distributed import make_train_step
    from repro_torch.kernels.common import resolve_device

    dev = resolve_device(device)
    exp_n = dataclasses.replace(MNIST_CONVEX, num_clients=clients)
    spec = policies.PolicySpec.from_experiment(exp_n, rounds)
    policy = policies.make_legacy("cocs", spec, seed=seed,
                                  h_t=MNIST_CONVEX.h_t, device=dev)
    sim = envs.make(scenario, exp_n).make_sim(seed)
    shards = client_token_shards(clients, cfg.vocab_size, seq_len, batch,
                                 seed=seed)
    rngs = [np.random.default_rng(seed + c) for c in range(clients)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    step = make_train_step(cfg, lr=lr)
    history = []
    t0 = time.time()
    for t in range(rounds):
        rd = sim.round(t)
        assign = policy.select(rd)
        policy.update(rd, assign)
        sel = np.nonzero(assign >= 0)[0]
        losses = []
        for c in sel:
            tb = {k: torch.as_tensor(v, device=dev)
                  for k, v in shards[c].sample(rngs[c]).items()}
            tb.update(_embeddings(cfg, batch, gen, dev))
            w = torch.full((batch,), float(rd.outcomes[c, assign[c]]),
                           dtype=torch.float32, device=dev)
            params, loss = step(params, tb, w)
            losses.append(float(loss))
        history.append((sel, losses))
        if verbose and ((t + 1) % 10 == 0 or t == 0):
            mean = np.mean(losses) if losses else float("nan")
            print(f"round {t+1:4d}  clients {len(sel):2d}  "
                  f"mean_loss {mean:.4f}  ({time.time()-t0:.0f}s)",
                  flush=True)
    return params, history


def _embeddings(cfg, batch: int, gen: torch.Generator,
                dev) -> Dict[str, torch.Tensor]:
    """The frames (``audio``) or patches (``vlm``) of one training batch."""
    n = {"audio": ("frames", cfg.num_frames),
         "vlm": ("patches", cfg.num_patches)}.get(cfg.arch_type)
    if n is None:
        return {}
    return {n[0]: torch.randn((batch, n[1], cfg.d_model), generator=gen,
                              device=dev).to(cfg.torch_dtype)}


def run_lm(args) -> int:
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models import registry as R

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = R.init_params(cfg, args.seed, device=dev)
    lm_rounds(cfg, params, clients=args.clients, rounds=args.rounds,
              seq_len=args.seq_len, batch=args.batch, lr=args.lr,
              scenario=args.scenario, seed=args.seed, device=dev)
    return 0


def main(argv=None) -> int:
    from repro_torch import envs
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--paper", action="store_true")
    ap.add_argument("--nonconvex", action="store_true")
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--scenario", default="paper",
                    choices=sorted(envs.SCENARIOS))
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
