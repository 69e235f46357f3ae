"""``sweep_experiments``: whole multi-seed HFL experiments on a device
environment, one training block per eval interval.

Every seed gets its own realized environment (``sim``), model init
(``PRNGKey(seed)``; logreg starts at zero), sampler stream
(``PRNGKey(seed + 11)``) and policy state, over one shared dataset
(``seed=0``), as the reference's ``sweep_experiments``; the seed axis is
a batch dimension throughout. Policies: ``cocs``, ``oracle``, ``random``
(by registry name, or built, as a dict name -> policy); models:
``logreg`` (784-d "mnist" data) and ``cnn`` (32x32x3 "cifar" data).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import policies as registry
from repro_torch import random as jr
from repro_torch.core.utility import _policy_kwargs
from repro_torch.data.federated import FederatedDataset, StackedClients
from repro_torch.experiment.fused import block_device
from repro_torch.fed.batched import BatchedRoundSpec
from repro_torch.kernels.common import resolve_device
from repro_torch.models.logistic import init_cnn, init_logreg
from repro_torch.policies.base import FunctionalPolicy, PolicySpec
from repro_torch.sim import spec as simspec
from repro_torch.sim.core import init_statics


@dataclass
class SweepResult:
    """Per-policy, per-seed experiment trajectories (numpy)."""
    policies: List[str]
    seeds: List[int]
    eval_rounds: np.ndarray                      # (E,) 1-based round ids
    accuracy: Dict[str, np.ndarray]              # (S, E)
    loss: Dict[str, np.ndarray]                  # (S, E)
    utilities: Dict[str, np.ndarray]             # (S, T)
    participants: Dict[str, np.ndarray]          # (S, T)
    selections: Dict[str, np.ndarray]            # (S, T, N)
    explored: Dict[str, np.ndarray] = field(default_factory=dict)
    # the port's own addition: local SGD's loss at its first and last
    # step, the mean over each round's filled slots (S, T, 2)
    train_loss: Dict[str, np.ndarray] = field(default_factory=dict)


def _block_bounds(horizon: int, eval_every: int) -> List[int]:
    """Exclusive block ends: an eval after every ``eval_every`` rounds
    and after the final round."""
    return [t + 1 for t in range(horizon)
            if (t + 1) % eval_every == 0 or t == horizon - 1]


class TrainingSetup(NamedTuple):
    data: FederatedDataset
    stacked: StackedClients
    batch: int                 # batch size clamped to smallest shard
    steps: int                 # local SGD steps per round
    edge_seed: Dict[str, torch.Tensor]   # (S, M, ...) initial edge params
    base_keys: torch.Tensor    # (S, 2) per-seed sampler keys
    spec: BatchedRoundSpec
    test_x: torch.Tensor
    test_y: torch.Tensor


def prepare_training(cfg, model_kind: str, batch_size: int,
                     batches_per_epoch: int,
                     data: Optional[FederatedDataset],
                     seeds: Sequence[int], device) -> TrainingSetup:
    """Training state shared by every seed: the synthetic dataset
    (``seed=0``; "mnist" for logreg, "cifar" for the CNN) unless given,
    stacked shards on ``device``, per-seed edge models (logreg at zero,
    the CNN from ``init_cnn(PRNGKey(seed))`` at the data's shape),
    sampler keys ``PRNGKey(seed + 11)`` and the round spec."""
    if model_kind not in ("logreg", "cnn"):
        raise ValueError(f"unknown model kind {model_kind!r}; the port "
                         "has 'logreg' and 'cnn'")
    kind = "mnist" if model_kind == "logreg" else "cifar"
    data = data or FederatedDataset.synthetic(cfg.num_clients, kind=kind,
                                              seed=0)
    stacked = data.stacked(device)
    batch = int(min(batch_size, int(stacked.sizes.min())))
    steps = cfg.local_epochs * batches_per_epoch
    s, m = len(seeds), cfg.num_edge_servers
    if model_kind == "logreg":
        nf = int(np.prod(data.test_x.shape[1:]))
        p0 = init_logreg(num_features=nf, device=device)
        edge = {k: v.expand((s, m) + v.shape).clone()
                for k, v in p0.items()}
    else:
        h, w, c = data.test_x.shape[1:]
        inits = [init_cnn(jr.PRNGKey(int(x), device), h, w, c)
                 for x in seeds]
        edge = {k: torch.stack([p[k] for p in inits])[:, None]
                .expand((s, m) + inits[0][k].shape).clone()
                for k in inits[0]}
    spec = BatchedRoundSpec(num_edge_servers=m, steps=steps, lr=cfg.lr,
                            z_min=cfg.min_clients_z, t_es=cfg.t_es,
                            model=model_kind)
    base_keys = jr.PRNGKey(torch.as_tensor([int(x) + 11 for x in seeds]),
                           device)
    return TrainingSetup(
        data=data, stacked=stacked, batch=batch, steps=steps,
        edge_seed=edge, base_keys=base_keys, spec=spec,
        test_x=torch.as_tensor(data.test_x, device=device),
        test_y=torch.as_tensor(data.test_y, device=device))


def _make_policies(policies: Sequence[str], cfg, horizon
                   ) -> Dict[str, FunctionalPolicy]:
    """Registry names -> policies, COCS with the config's knobs (as the
    reference's ``_policy_kwargs``)."""
    spec = PolicySpec.from_experiment(cfg, horizon)
    return {name: registry.make(name, spec,
                                **_policy_kwargs(cfg, name.lower()))
            for name in policies}


def sweep_experiments(policies: Union[Sequence[str],
                                      Dict[str, FunctionalPolicy]],
                      env, seeds: Sequence[int], horizon: int, *,
                      model_kind: str = "logreg", batch_size: int = 32,
                      batches_per_epoch: int = 2, eval_every: int = 5,
                      data: Optional[FederatedDataset] = None,
                      slots_per_es: Optional[int] = None,
                      policy_seed_offset: int = 0,
                      device=None) -> SweepResult:
    """Run every policy for every seed over ``horizon`` training rounds
    on a device environment (``"device:<preset>"``).

    ``policies`` is a list of registry names (COCS with the config's
    knobs) or a dict name -> ``FunctionalPolicy``.
    ``policy_seed_offset`` shifts the policy init seeds from the env
    seeds (``core.utility.POLICY_TABLE``'s offsets); the env, model and
    sampler streams stay keyed on the env seeds.

    ``device=None`` runs on CUDA and raises without a CUDA device; pass
    ``device="cpu"`` for the plain PyTorch path. ``slots_per_es`` pins
    the per-ES slot capacity (a round that assigns more raises);
    ``None`` sizes each round to its largest cohort."""
    dev = resolve_device(device)
    env = simspec.resolve(env)
    cfg = env.cfg
    seeds = [int(x) for x in seeds]
    pols = (dict(policies) if isinstance(policies, dict)
            else _make_policies(policies, cfg, horizon))
    pol_seeds = [x + int(policy_seed_offset) for x in seeds]
    setup = prepare_training(cfg, model_kind, batch_size,
                             batches_per_epoch, data, seeds, dev)
    seed_t = torch.as_tensor(seeds, dtype=torch.int64, device=dev)
    statics = init_statics(env.spec, seed_t)
    ends = _block_bounds(horizon, eval_every)
    result = SweepResult(policies=list(pols), seeds=seeds,
                         eval_rounds=np.asarray(ends), accuracy={}, loss={},
                         utilities={}, participants={}, selections={},
                         explored={})
    for name, pol in pols.items():
        pstate = pol.init(len(seeds), dev, pol_seeds)
        edge = {k: v.clone() for k, v in setup.edge_seed.items()}
        pos = statics.pos0.clone()
        outs, lo = [], 0
        for hi in ends:
            out = block_device(pol, setup.spec, env.spec, pstate, edge, pos,
                               seed_t, statics, lo, hi, setup.stacked,
                               setup.base_keys, setup.batch, setup.test_x,
                               setup.test_y, slots=slots_per_es)
            pstate, edge, pos = out.policy_state, out.edge_params, \
                out.env_pos
            outs.append(out)
            lo = hi
        host = lambda f, cat: (torch.cat if cat else torch.stack)(
            [getattr(o, f) for o in outs], dim=1).cpu().numpy()
        result.accuracy[name] = host("accuracy", False)
        result.loss[name] = host("loss", False)
        result.utilities[name] = host("utilities", True)
        result.participants[name] = host("participants", True)
        result.selections[name] = host("selections", True)
        result.explored[name] = host("explored", True)
        result.train_loss[name] = host("train_loss", True)
    return result
