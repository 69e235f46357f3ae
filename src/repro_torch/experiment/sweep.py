"""``sweep_experiments``: whole multi-seed HFL experiments, one training
block per eval interval, the engine of ``repro_torch.run``'s training
tiers.

Every seed gets its own realized environment, model init
(``PRNGKey(seed)``; logreg starts at zero), sampler stream
(``PRNGKey(seed + 11)``) and policy state, over one shared dataset
(``seed=0``), as the reference's ``sweep_experiments``. Three paths:

* tier 4, a device env (``"device:<preset>"``) and a tensor policy: the
  rounds are generated inside each block (``fused.block_device``), the
  seed axis a batch dimension throughout;
* tier 3, a host env (``"paper"``, ``"host:<scenario>"``, an
  ``envs.HFLEnv``) and a tensor policy: the rounds are realized on the
  host (float64 numpy), stacked, moved to the run's device once, and
  walked by ``fused.block_host``;
* tier 2, a host-state policy (``cucb``, ``linucb``, ``cocs-phased``):
  one seed at a time, the policy selects on ``RoundData`` on the host
  and the assignment trains through ``fed.batched.train_round`` as a
  (1, N) tensor (a device env's rounds are realized for it by
  ``DeviceEnv.rollout``).

Policies are registry names (COCS with the config's knobs) or built, as
a dict name -> policy; models: ``logreg`` and its transposed layout
``logreg-t`` (784-d "mnist" data) and ``cnn`` (32x32x3 "cifar" data).

Faults come from the env (``HFLEnv.faults`` / ``SimSpec.faults``): its
rounds carry the dropout, straggler and outage events, and every tier
corrupts updates from the env seeds. ``aggregator``/``trim_frac`` pick
the Eq. 3 rule (``fed.robust``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import policies as registry
from repro_torch import random as jr
from repro_torch.core.utility import _policy_kwargs, realized_utility
from repro_torch.data.federated import FederatedDataset, StackedClients
from repro_torch.envs import cached_rollout
from repro_torch.experiment.fused import block_device, block_eval, \
    block_host
from repro_torch.fed.batched import BatchedRoundSpec, train_round
from repro_torch.kernels.common import resolve_device
from repro_torch.models.logistic import (MODEL_KINDS, init_cnn,
                                         init_logreg, init_logreg_t)
from repro_torch.policies.base import (FunctionalPolicy, PolicyAdapter,
                                       PolicySpec, Round, round_from_arrays,
                                       round_from_data, rounds_to_scan_axes)
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
    env_seeds: torch.Tensor    # (S,) the env seeds (update corruption)
    faults: object = None      # the env's FaultSpec, or None


def prepare_training(cfg, model_kind: str, batch_size: int,
                     batches_per_epoch: int,
                     data: Optional[FederatedDataset],
                     seeds: Sequence[int], device,
                     aggregator: str = "mean", trim_frac: float = 0.1,
                     faults=None) -> TrainingSetup:
    """Training state shared by every seed: the synthetic dataset
    (``seed=0``; "mnist" for logreg, "cifar" for the CNN) unless given,
    stacked shards on ``device``, per-seed edge models (logreg at zero,
    the CNN from ``init_cnn(PRNGKey(seed))`` at the data's shape),
    sampler keys ``PRNGKey(seed + 11)``, the round spec with its Eq. 3
    rule, and the env's ``faults`` (their corruption is drawn from the
    env seeds, ``seeds``)."""
    if model_kind not in MODEL_KINDS:
        raise ValueError(f"unknown model kind {model_kind!r}; the port "
                         f"has {MODEL_KINDS}")
    kind = "cifar" if model_kind == "cnn" else "mnist"
    data = data or FederatedDataset.synthetic(cfg.num_clients, kind=kind,
                                              seed=0)
    stacked = data.stacked(device)
    batch = int(min(batch_size, int(stacked.sizes.min())))
    steps = cfg.local_epochs * batches_per_epoch
    s, m = len(seeds), cfg.num_edge_servers
    if model_kind != "cnn":
        nf = int(np.prod(data.test_x.shape[1:]))
        init = init_logreg if model_kind == "logreg" else init_logreg_t
        p0 = init(num_features=nf, device=device)
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
                            model=model_kind, aggregator=aggregator,
                            trim_frac=float(trim_frac))
    base_keys = jr.PRNGKey(torch.as_tensor([int(x) + 11 for x in seeds]),
                           device)
    return TrainingSetup(
        data=data, stacked=stacked, batch=batch, steps=steps,
        edge_seed=edge, base_keys=base_keys, spec=spec,
        test_x=torch.as_tensor(data.test_x, device=device),
        test_y=torch.as_tensor(data.test_y, device=device),
        env_seeds=torch.as_tensor([int(x) for x in seeds],
                                  dtype=torch.int64, device=device),
        faults=faults)


def _make_policies(policies: Sequence[str], cfg, horizon
                   ) -> Dict[str, FunctionalPolicy]:
    """Registry names -> policies, COCS with the config's knobs (as the
    reference's ``_policy_kwargs``)."""
    spec = PolicySpec.from_experiment(cfg, horizon)
    return {name: registry.make(name, spec,
                                **_policy_kwargs(cfg, name.lower()))
            for name in policies}


def host_rounds(env, seed: int, horizon: int, dev) -> list:
    """A seed's ``RoundData`` for a host-state policy: a host env's cached
    rollout (``envs.cached_rollout``), or a device env's rounds realized
    on ``dev`` (``DeviceEnv.rollout``)."""
    if isinstance(env, simspec.DeviceEnv):
        return env.rollout(seed, horizon, device=dev)
    return list(cached_rollout(env, seed, horizon))


def sweep_experiments(policies: Union[Sequence[str],
                                      Dict[str, FunctionalPolicy]],
                      env, seeds: Sequence[int], horizon: int, *,
                      model_kind: str = "logreg", batch_size: int = 32,
                      batches_per_epoch: int = 2, eval_every: int = 5,
                      data: Optional[FederatedDataset] = None,
                      slots_per_es: Optional[int] = None,
                      policy_seed_offset: int = 0,
                      aggregator: str = "mean", trim_frac: float = 0.1,
                      device=None) -> SweepResult:
    """Run every policy for every seed over ``horizon`` training rounds.

    ``env`` is a host ``envs.HFLEnv``, a ``sim.spec.DeviceEnv`` or a
    string selector (``sim.spec.resolve``: ``"paper"`` is the host env,
    ``"device:paper"`` the device env). ``policies`` is a list of
    registry names (COCS with the config's knobs) or a dict name ->
    ``FunctionalPolicy``. ``policy_seed_offset`` shifts the policy init
    seeds from the env seeds (``core.utility.POLICY_TABLE``'s offsets);
    the env, model and sampler streams stay keyed on the env seeds, and
    so does update corruption: faults come from the env itself
    (``HFLEnv.faults`` / ``SimSpec.faults``). ``aggregator`` and
    ``trim_frac`` pick the Eq. 3 rule (``fed.robust.AGGREGATORS``).
    A host env's rounds come from its rollout cache
    (``envs.cached_rollout``), so the policies of a panel share them.

    ``device=None`` runs on CUDA and raises without a CUDA device; pass
    ``device="cpu"`` for the plain PyTorch path. A host env's rounds are
    realized on the CPU either way (its design) and then moved to
    ``device``. ``slots_per_es`` pins the per-ES slot capacity (a round
    that assigns more raises); ``None`` sizes each round to its largest
    cohort."""
    dev = resolve_device(device)
    env = simspec.resolve(env)
    device_env = isinstance(env, simspec.DeviceEnv)
    cfg = env.cfg
    seeds = [int(x) for x in seeds]
    pols = (dict(policies) if isinstance(policies, dict)
            else _make_policies(policies, cfg, horizon))
    pol_seeds = [x + int(policy_seed_offset) for x in seeds]
    faults = env.spec.faults if device_env else env.faults
    setup = prepare_training(cfg, model_kind, batch_size,
                             batches_per_epoch, data, seeds, dev,
                             aggregator, trim_frac, faults)
    ends = _block_bounds(horizon, eval_every)

    scan_rounds = None
    if not device_env and any(p.tensor_capable for p in pols.values()):
        scan_rounds = round_from_arrays(
            rounds_to_scan_axes(env.rollout_multi(seeds, horizon)), dev)
    seed_t = setup.env_seeds
    result = SweepResult(policies=list(pols), seeds=seeds,
                         eval_rounds=np.asarray(ends), accuracy={}, loss={},
                         utilities={}, participants={}, selections={},
                         explored={})
    for name, pol in pols.items():
        if not pol.tensor_capable:
            out = run_host(pol, setup,
                           [host_rounds(env, x, horizon, dev) for x in seeds],
                           pol_seeds, ends, slots_per_es)
        elif device_env:
            out = run_fused_device(pol, setup, env.spec, seed_t,
                                   init_statics(env.spec, seed_t),
                                   pol.init(len(seeds), dev, pol_seeds),
                                   ends, slots_per_es)
        else:
            out = run_fused(pol, setup, scan_rounds,
                            pol.init(len(seeds), dev, pol_seeds), ends,
                            slots_per_es)
        for f in ("accuracy", "loss", "utilities", "participants",
                  "selections", "explored", "train_loss"):
            getattr(result, f)[name] = out[f]
    return result


_BLOCK_FIELDS = {"accuracy": False, "loss": False, "utilities": True,
                 "participants": True, "selections": True,
                 "explored": True, "train_loss": True}


def _collect_blocks(outs) -> Dict[str, np.ndarray]:
    """Per-block outputs -> host numpy with leading (S, T) or (S, E)."""
    return {f: (torch.cat if cat else torch.stack)(
        [getattr(o, f) for o in outs], dim=1).cpu().numpy()
        for f, cat in _BLOCK_FIELDS.items()}


def run_fused_device(pol: FunctionalPolicy, setup: TrainingSetup,
                     sim_spec, seed_t: torch.Tensor, statics, pstate,
                     ends: List[int], slots: Optional[int] = None,
                     budgets: Optional[torch.Tensor] = None,
                     deadlines: Optional[torch.Tensor] = None
                     ) -> Dict[str, np.ndarray]:
    """Tier 4: every batch element at once, one ``block_device`` an eval
    interval (``budgets``/``deadlines``: a grid's per-element cells)."""
    edge = {k: v.clone() for k, v in setup.edge_seed.items()}
    pos = statics.pos0.clone()
    outs, lo = [], 0
    for hi in ends:
        out = block_device(pol, setup.spec, sim_spec, pstate, edge, pos,
                           seed_t, statics, lo, hi, setup.stacked,
                           setup.base_keys, setup.batch, setup.test_x,
                           setup.test_y, slots=slots, budgets=budgets,
                           deadlines=deadlines)
        pstate, edge, pos = out.policy_state, out.edge_params, out.env_pos
        outs.append(out)
        lo = hi
    return _collect_blocks(outs)


def run_fused(pol: FunctionalPolicy, setup: TrainingSetup,
              scan_rounds: Round, pstate, ends: List[int],
              slots: Optional[int] = None,
              budgets: Optional[torch.Tensor] = None
              ) -> Dict[str, np.ndarray]:
    """Tier 3: the host env's (T, S, ...) rounds, one ``block_host`` an
    eval interval (corruption from ``setup.faults`` and its env
    seeds)."""
    edge = {k: v.clone() for k, v in setup.edge_seed.items()}
    outs, lo = [], 0
    for hi in ends:
        out = block_host(pol, setup.spec, pstate, edge,
                         Round(*(f[lo:hi] for f in scan_rounds)),
                         setup.stacked, setup.base_keys, setup.batch,
                         setup.test_x, setup.test_y, slots=slots,
                         budgets=budgets, faults=setup.faults,
                         env_seeds=setup.env_seeds)
        pstate, edge = out.policy_state, out.edge_params
        outs.append(out)
        lo = hi
    return _collect_blocks(outs)


def run_host(pol: FunctionalPolicy, setup: TrainingSetup, rounds_per_seed,
             pol_seeds: Sequence[int], ends: List[int],
             slots: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Tier 2: one seed at a time, a ``PolicyAdapter`` selects on each
    ``RoundData`` and the assignment trains through ``train_round`` as a
    (1, N) tensor; utilities in float64 (``realized_utility``), as the
    reference's ``_run_host``. Corruption comes from ``setup.faults``
    and each seed's env seed."""
    s, horizon = len(rounds_per_seed), len(rounds_per_seed[0])
    n = pol.spec.num_clients
    dev = setup.base_keys.device
    out = {"accuracy": np.zeros((s, len(ends))),
           "loss": np.zeros((s, len(ends))),
           "utilities": np.zeros((s, horizon)),
           "participants": np.zeros((s, horizon)),
           "selections": np.zeros((s, horizon, n), np.int64),
           "explored": np.zeros((s, horizon), bool),
           "train_loss": np.zeros((s, horizon, 2), np.float32)}
    for si in range(s):
        adapter = PolicyAdapter(pol, seed=pol_seeds[si])
        base_key = setup.base_keys[si:si + 1]
        env_seed = setup.env_seeds[si:si + 1]
        edge = {k: v[si:si + 1].clone() for k, v in setup.edge_seed.items()}
        lo = 0
        for ei, hi in enumerate(ends):
            parts, losses = [], []
            for t in range(lo, hi):
                rd = rounds_per_seed[si][t]
                assign = adapter.step(rd)
                out["selections"][si, t] = assign
                out["explored"][si, t] = adapter.last_explored
                out["utilities"][si, t] = realized_utility(
                    assign, rd, pol.spec.sqrt_utility)
                view = round_from_data(rd)._replace(t=np.int32(t))
                r = round_from_arrays([np.asarray(f)[None] for f in view],
                                      dev)
                a = torch.as_tensor(np.asarray(assign, np.int32)[None],
                                    device=dev)
                edge, p, loss = train_round(setup.spec, edge, a, r,
                                            setup.stacked, base_key,
                                            setup.batch, slots,
                                            setup.faults, env_seed)
                parts.append(p)
                losses.append(loss)
            out["participants"][si, lo:hi] = torch.cat(parts).cpu().numpy()
            out["train_loss"][si, lo:hi] = torch.cat(losses).cpu().numpy()
            acc, loss = block_eval(edge, setup.test_x, setup.test_y,
                                   setup.spec.model)
            out["accuracy"][si, ei] = float(acc[0])
            out["loss"][si, ei] = float(loss[0])
            lo = hi
    return out
