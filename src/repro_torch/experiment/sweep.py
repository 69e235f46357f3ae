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

Tiers 3 and 4 also run resilient (the reference's ``sweep.py:309-469``):
one atomic checkpoint an eval interval, a resume that continues from the
newest one and reproduces the uninterrupted run bitwise, and the health
guard over each interval's carry and outputs. ``telemetry=True`` threads
the ``obs.telemetry`` taps through their blocks. Each block runs under a
``fused_block`` (tier 3) or ``fused_block_device`` (tier 4) span of the
``obs.trace`` tracer.
"""
from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Union

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
from repro_torch.obs import trace as obs_trace
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
    # per policy, with the health guard on: {"checked": int, "events":
    # [{"interval": int, "round_end": int, "bad": [leaf names]}]}
    health: Dict[str, dict] = field(default_factory=dict)
    # per policy, with telemetry on: {"series": {metric: (S, T)},
    # "totals": {metric: (S,)}, "summary": {...}}; None for tier 2
    telemetry: Dict[str, Optional[dict]] = field(default_factory=dict)


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
                     faults=None, rows: Optional[tuple] = None
                     ) -> TrainingSetup:
    """Training state shared by every seed: the synthetic dataset
    (``seed=0``; "mnist" for logreg, "cifar" for the CNN) unless given,
    stacked shards on ``device``, per-seed edge models (logreg at zero,
    the CNN from ``init_cnn(PRNGKey(seed))`` at the data's shape),
    sampler keys ``PRNGKey(seed + 11)``, the round spec with its Eq. 3
    rule, and the env's ``faults`` (their corruption is drawn from the
    env seeds, ``seeds``). ``rows=(lo, hi)`` stacks only those clients'
    shards (a client shard of the sharded engine; ``sizes`` stays the
    global (N,) vector)."""
    if model_kind not in MODEL_KINDS:
        raise ValueError(f"unknown model kind {model_kind!r}; the port "
                         f"has {MODEL_KINDS}")
    kind = "cifar" if model_kind == "cnn" else "mnist"
    data = data or FederatedDataset.synthetic(cfg.num_clients, kind=kind,
                                              seed=0)
    stacked = (data.stacked(device) if rows is None
               else data.stacked_rows(rows[0], rows[1], device))
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
                      checkpoint_dir: Optional[str] = None,
                      resume: bool = False, health: str = "off",
                      stop_after_blocks: Optional[int] = None,
                      telemetry: bool = False,
                      shard_seeds: Optional[bool] = None,
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

    Tiers 3 and 4 (tensor policies): with ``checkpoint_dir`` each eval
    interval ends with an atomic checkpoint of the carry and the
    outputs so far, in a subdirectory a policy; ``resume=True``
    continues from the newest one (a checkpoint of another run, another
    telemetry mode or another device type is refused) and reproduces
    the uninterrupted run bitwise. ``health`` ("off", "record", "halt")
    scans each interval's carry and outputs for non-finite values into
    ``SweepResult.health``, or raises ``RuntimeError``.
    ``stop_after_blocks`` raises ``SimulatedKill`` after that many
    intervals (a kill the tests can place). ``telemetry=True`` fills
    ``SweepResult.telemetry``. Tier-2 policies run without these hooks
    (warned) and report no telemetry.

    ``device=None`` runs on CUDA and raises without a CUDA device; pass
    ``device="cpu"`` for the plain PyTorch path. A host env's rounds are
    realized on the CPU either way (its design) and then moved to
    ``device``. ``slots_per_es`` pins the per-ES slot capacity (a round
    that assigns more raises); ``None`` sizes each round to its largest
    cohort.

    ``shard_seeds`` splits the seeds over the ranks of a
    ``torch.distributed`` group (the reference's seed mesh,
    ``seed_split``): each rank runs its seeds and every rank returns the
    whole result; a resilient run's checkpoints go to ``rank<r>`` under
    ``checkpoint_dir``."""
    if health not in ("off", "record", "halt"):
        raise ValueError(
            f"health must be 'off', 'record' or 'halt', got {health!r}")
    split = seed_split(len(seeds), shard_seeds)
    if split is not None:
        rank, k = split
        per = len(seeds) // k
        mine = [int(x) for x in seeds][rank * per:(rank + 1) * per]
        local = sweep_experiments(
            policies, env, mine, horizon, model_kind=model_kind,
            batch_size=batch_size, batches_per_epoch=batches_per_epoch,
            eval_every=eval_every, data=data, slots_per_es=slots_per_es,
            policy_seed_offset=policy_seed_offset, aggregator=aggregator,
            trim_frac=trim_frac,
            checkpoint_dir=(None if checkpoint_dir is None else
                            os.path.join(checkpoint_dir, f"rank{rank}")),
            resume=resume, health=health,
            stop_after_blocks=stop_after_blocks, telemetry=telemetry,
            shard_seeds=False, device=device)
        return _gather_seeds(local, [int(x) for x in seeds])
    dev = resolve_device(device)
    env = simspec.resolve(env)
    device_env = isinstance(env, simspec.DeviceEnv)
    cfg = env.cfg
    seeds = [int(x) for x in seeds]
    pols = (dict(policies) if isinstance(policies, dict)
            else _make_policies(policies, cfg, horizon))
    pol_seeds = [x + int(policy_seed_offset) for x in seeds]
    faults = env.spec.faults if device_env else env.faults
    resilient = (checkpoint_dir is not None or health != "off"
                 or stop_after_blocks is not None)
    with obs_trace.span("train.prepare", seeds=len(seeds),
                        model=model_kind):
        setup = prepare_training(cfg, model_kind, batch_size,
                                 batches_per_epoch, data, seeds, dev,
                                 aggregator, trim_frac, faults)
    ends = _block_bounds(horizon, eval_every)

    scan_rounds = None
    if not device_env and any(p.tensor_capable for p in pols.values()):
        with obs_trace.span("env.realize", seeds=len(seeds),
                            horizon=horizon):
            scan_rounds = round_from_arrays(
                rounds_to_scan_axes(env.rollout_multi(seeds, horizon)), dev)
    seed_t = setup.env_seeds
    result = SweepResult(policies=list(pols), seeds=seeds,
                         eval_rounds=np.asarray(ends), accuracy={}, loss={},
                         utilities={}, participants={}, selections={},
                         explored={})
    for name, pol in pols.items():
        ctx = None
        if not pol.tensor_capable:
            if resilient:
                warnings.warn(
                    "checkpoint/resume and health guards apply to the "
                    f"fused training tiers only; host-loop policy {name!r} "
                    "runs without them", stacklevel=2)
            out = run_host(pol, setup,
                           [host_rounds(env, x, horizon, dev) for x in seeds],
                           pol_seeds, ends, slots_per_es)
        else:
            if resilient:
                pdir = None
                if checkpoint_dir is not None:
                    safe = "".join(c if c.isalnum() or c in "-_." else "_"
                                   for c in name)
                    pdir = os.path.join(checkpoint_dir, safe)
                ctx = _ResilientCtx(
                    ckpt_dir=pdir, resume=bool(resume), health=health,
                    stop_after=stop_after_blocks,
                    fingerprint=_run_fingerprint(
                        name, pol, setup, env, seeds, pol_seeds, ends,
                        slots_per_es, dev, telemetry))
            pstate = pol.init(len(seeds), dev, pol_seeds)
            if device_env:
                out = run_fused_device(pol, setup, env.spec, seed_t,
                                       init_statics(env.spec, seed_t),
                                       pstate, ends, slots_per_es, ctx=ctx,
                                       telemetry=telemetry)
            else:
                out = run_fused(pol, setup, scan_rounds, pstate, ends,
                                slots_per_es, ctx=ctx, telemetry=telemetry)
        for f in _BLOCK_FIELDS:
            getattr(result, f)[name] = out[f]
        result.telemetry[name] = out.get("telemetry")
        if ctx is not None and health != "off":
            result.health[name] = ctx.report
    return result


def seed_split(n: int, shard_seeds: Optional[bool]):
    """``(rank, ranks)`` when ``n`` batch elements split over the ranks of
    the process group (the reference's ``_seed_mesh``: ``shard_seeds``
    None or True, more than one rank, ``n`` divisible), else None;
    ``shard_seeds=True`` that cannot split warns and runs unsharded, as
    the reference does on one device."""
    from repro_torch.launch.mesh import world_size

    if shard_seeds is False:
        return None
    k = world_size()
    if k <= 1 or n % k != 0:
        if shard_seeds:
            warnings.warn(
                f"seed-axis sharding requested but {n} seeds do not "
                f"tile {k} device(s); running unsharded", stacklevel=3)
        return None
    return torch.distributed.get_rank(), k


def gather_objects(obj) -> list:
    """Every rank's ``obj`` in rank order (one collective)."""
    from repro_torch.launch.mesh import COLLECTIVES, world_size

    parts = [None] * world_size()
    torch.distributed.all_gather_object(parts, obj)
    COLLECTIVES["seeds"] = COLLECTIVES.get("seeds", 0) + 1
    return parts


def _gather_seeds(local: SweepResult, seeds: List[int]) -> SweepResult:
    """Each rank's ``SweepResult`` over its seeds -> the whole run's, on
    every rank."""
    from repro_torch.obs.telemetry import summarize

    parts = gather_objects(local)
    cat = lambda f, name: np.concatenate([getattr(p, f)[name]
                                          for p in parts])
    out = SweepResult(policies=local.policies, seeds=seeds,
                      eval_rounds=local.eval_rounds, accuracy={}, loss={},
                      utilities={}, participants={}, selections={},
                      explored={})
    for name in local.policies:
        for f in _BLOCK_FIELDS:
            getattr(out, f)[name] = cat(f, name)
        if name in local.health:
            out.health[name] = {
                "checked": local.health[name]["checked"],
                "events": [e for p in parts for e in p.health[name]["events"]]}
        tele = [p.telemetry.get(name) for p in parts]
        if all(t is not None for t in tele):
            series = {k: np.concatenate([t["series"][k] for t in tele])
                      for k in tele[0]["series"]}
            totals = {k: np.concatenate([t["totals"][k] for t in tele])
                      for k in tele[0]["totals"]}
            out.telemetry[name] = {"series": series, "totals": totals,
                                   "summary": summarize(series, totals)}
        else:
            out.telemetry[name] = None
    return out


_BLOCK_FIELDS = {"accuracy": False, "loss": False, "utilities": True,
                 "participants": True, "selections": True,
                 "explored": True, "train_loss": True}


def _collect_blocks(outs, telemetry: bool = False) -> Dict[str, Any]:
    """Per-block outputs -> host numpy with leading (S, T) or (S, E), and
    the run's telemetry (None without taps)."""
    res = {f: (torch.cat if cat else torch.stack)(
        [getattr(o, f) for o in outs], dim=1).cpu().numpy()
        for f, cat in _BLOCK_FIELDS.items()}
    if telemetry:
        from repro_torch.obs.telemetry import collect
        res["telemetry"] = collect([o.telemetry for o in outs],
                                   [o.tele_acc for o in outs])
    return res


# -- resilient execution: checkpoints, resume, the health guard ---------------
# One block an eval interval, and the interval's end is the checkpoint's
# grain: the exact carry (policy state, edge params, a device env's
# positions), every finished interval's outputs and the interval count,
# written atomically. A resumed run continues from the carry the
# uninterrupted run had there and reproduces its decisions bitwise. A
# fingerprint (draw schedule, policy, spec, world, seeds, interval
# layout, telemetry mode, device type) refuses a checkpoint of another
# run. CPU and CUDA runs of the port are not bitwise equal, so a
# checkpoint resumes only on the device type that wrote it.


class SimulatedKill(RuntimeError):
    """Raised after ``stop_after_blocks`` intervals: a deterministic
    stand-in for a process killed mid-run."""


@dataclass
class _ResilientCtx:
    """One policy's state in the resilient runner."""
    ckpt_dir: Optional[str]          # None: health and kill hooks only
    resume: bool
    health: str                      # "off" | "record" | "halt"
    stop_after: Optional[int]
    fingerprint: str
    report: dict = field(default_factory=lambda: {"checked": 0,
                                                  "events": []})
    outs: list = field(default_factory=list)   # records, CPU tensors


def _run_fingerprint(name: str, pol, setup: TrainingSetup, env, seeds,
                     pol_seeds, ends, slots, dev, telemetry: bool) -> str:
    from repro_torch.sim.draws import SCHEDULE_ID
    fp = {"schedule": SCHEDULE_ID, "policy": name, "config": repr(pol),
          "spec": repr(setup.spec), "batch": setup.batch,
          "world": repr(env), "seeds": list(seeds),
          "policy_seeds": list(pol_seeds), "ends": list(ends),
          "slots": slots, "device": dev.type}
    if telemetry:
        fp["telemetry"] = True
    return json.dumps(fp, sort_keys=True)


def _leaves(tree, path: str = ""):
    """``(path, leaf)`` pairs in the reference's pytree order: dict keys
    sorted, NamedTuple fields and sequence items in order, ``None`` no
    leaf; paths as ``jax.tree_util.keystr`` writes them
    (``['edge']['w']``, ``.p_hat``, ``[0]``)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken in ``_leaves``
    order from the iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _like(template, restored):
    """A restored carry in the template's structure (NamedTuples come
    back as lists), each leaf on its template leaf's device; a leaf of
    another count, shape or dtype raises."""
    want = [v for _, v in _leaves(template)]
    got = [v for _, v in _leaves(restored)]
    if len(got) != len(want):
        raise ValueError(
            f"checkpoint carry has {len(got)} leaves, expected "
            f"{len(want)}: written by a different model or policy?")
    moved = []
    for w, g in zip(want, got):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise ValueError(
                f"checkpoint carry leaf {tuple(g.shape)} {g.dtype}, "
                f"expected {tuple(w.shape)} {w.dtype}")
        moved.append(g.to(w.device))
    return _rebuild(template, iter(moved))


def _out_record(out) -> dict:
    """A block's outputs as plain dicts of CPU tensors (the checkpoint's
    ``outs``; telemetry as dicts of its fields)."""
    rec = {f: getattr(out, f).cpu() for f in _BLOCK_FIELDS}
    if out.telemetry is not None:
        rec["telemetry"] = {k: v.cpu()
                            for k, v in out.telemetry._asdict().items()}
        rec["tele_acc"] = {k: v.cpu()
                           for k, v in out.tele_acc._asdict().items()}
    return rec


def _try_resume(ctx: _ResilientCtx, template: dict, dev):
    """The newest checkpoint as ``(blocks_done, carry, outs)``, or None
    when there is none; a checkpoint of another run raises."""
    from repro_torch.checkpoint import latest_checkpoint, restore_pytree
    if ctx.ckpt_dir is None:
        return None
    path = latest_checkpoint(ctx.ckpt_dir)
    if path is None:
        return None
    payload = restore_pytree(path)
    if payload["fingerprint"] != ctx.fingerprint:
        raise ValueError(
            f"checkpoint {path!r} was written by a different run "
            "configuration (draw schedule / policy / spec / seeds / "
            "interval layout / telemetry mode / device type mismatch); "
            "refusing to resume — point checkpoint_dir at a fresh "
            "directory or disable resume")
    carry = {k: _like(template[k], payload["carry"][k]) for k in template}
    ctx.outs = list(payload["outs"])
    ctx.report = json.loads(payload["health"])
    outs = [SimpleNamespace(**{f: rec[f].to(dev) for f in _BLOCK_FIELDS},
                            telemetry=rec.get("telemetry"),
                            tele_acc=rec.get("tele_acc"))
            for rec in ctx.outs]
    return int(payload["blocks_done"]), carry, outs


def _bad_leaves(tag: str, tree) -> list:
    return [tag + path for path, leaf in _leaves(tree)
            if leaf.is_floating_point()
            and not bool(torch.isfinite(leaf).all())]


def _after_block(ctx: _ResilientCtx, bi: int, hi: int, carry: dict, out):
    """The end of an interval: the health scan, the atomic checkpoint,
    the simulated kill. Reading the carry costs a device sync and a copy
    an interval, the price of resilience; with ``ctx=None`` the blocks
    stay in flight and never come here."""
    from repro_torch.checkpoint import save_pytree
    rec = _out_record(out)
    ctx.outs.append(rec)
    if ctx.health != "off":
        # the port's train_loss is checkpointed, not scanned: a record
        # names the leaves the reference's names
        scanned = {k: v for k, v in rec.items() if k != "train_loss"}
        bad = _bad_leaves("carry", carry) + _bad_leaves("out", scanned)
        ctx.report["checked"] += 1
        if bad:
            ctx.report["events"].append(
                {"interval": bi, "round_end": hi, "bad": bad})
            obs_trace.event("health", interval=bi, round_end=hi, bad=bad)
            if ctx.health == "halt":
                raise RuntimeError(
                    f"non-finite training state after interval {bi} "
                    f"(round {hi}): {bad} — run with health='record' to "
                    "log and continue instead")
    if ctx.ckpt_dir is not None:
        with obs_trace.span("checkpoint.save", interval=bi, step=bi + 1):
            save_pytree(ctx.ckpt_dir, {
                "fingerprint": ctx.fingerprint, "blocks_done": bi + 1,
                "carry": carry, "outs": list(ctx.outs),
                "health": json.dumps(ctx.report)}, step=bi + 1)
    if ctx.stop_after is not None and bi + 1 >= ctx.stop_after:
        raise SimulatedKill(
            f"stop_after_blocks={ctx.stop_after}: run killed after "
            f"interval {bi + 1}"
            + ("" if ctx.ckpt_dir is None else
               f" (checkpoint {bi + 1} written to {ctx.ckpt_dir!r})"))


def _traced_block(name: str, run_block, bi: int, lo: int, hi: int,
                  slots: Optional[int], policy: str, dev):
    """One block under a span (the reference's ``_traced_block``). Under
    an active tracer the span also splits ``dispatch_us`` (the host
    loop) from ``execute_us`` (waiting on the device) with one
    synchronize; without one it is the bare call, outputs in flight."""
    with obs_trace.span(name, interval=bi, round_end=hi, rounds=hi - lo,
                        slots=slots, policy=policy) as at:
        if obs_trace.active() is None:
            return run_block()
        t0 = obs_trace.now_us()
        out = run_block()
        at["dispatch_us"] = obs_trace.now_us() - t0
        t1 = obs_trace.now_us()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        at["execute_us"] = obs_trace.now_us() - t1
        return out


def run_fused_device(pol: FunctionalPolicy, setup: TrainingSetup,
                     sim_spec, seed_t: torch.Tensor, statics, pstate,
                     ends: List[int], slots: Optional[int] = None,
                     budgets: Optional[torch.Tensor] = None,
                     deadlines: Optional[torch.Tensor] = None,
                     ctx: Optional[_ResilientCtx] = None,
                     telemetry: bool = False) -> Dict[str, Any]:
    """Tier 4: every batch element at once, one ``block_device`` an eval
    interval (``budgets``/``deadlines``: a grid's per-element cells;
    ``ctx``: the resilient runner's hooks)."""
    dev = seed_t.device
    edge = {k: v.clone() for k, v in setup.edge_seed.items()}
    pos = statics.pos0.clone()
    outs, start = [], 0
    if ctx is not None and ctx.resume:
        res = _try_resume(ctx, {"pstate": pstate, "edge": edge,
                                "pos": pos}, dev)
        if res is not None:
            start, carry, outs = res
            pstate, edge, pos = carry["pstate"], carry["edge"], carry["pos"]
    lo = ends[start - 1] if start > 0 else 0
    for bi in range(start, len(ends)):
        hi = ends[bi]
        out = _traced_block(
            "fused_block_device",
            lambda: block_device(pol, setup.spec, sim_spec, pstate, edge,
                                 pos, seed_t, statics, lo, hi,
                                 setup.stacked, setup.base_keys,
                                 setup.batch, setup.test_x, setup.test_y,
                                 slots=slots, budgets=budgets,
                                 deadlines=deadlines, telemetry=telemetry),
            bi, lo, hi, slots, pol.name, dev)
        pstate, edge, pos = out.policy_state, out.edge_params, out.env_pos
        outs.append(out)
        if ctx is not None:
            _after_block(ctx, bi, hi, {"pstate": pstate, "edge": edge,
                                       "pos": pos}, out)
        lo = hi
    return _collect_blocks(outs, telemetry)


def run_fused(pol: FunctionalPolicy, setup: TrainingSetup,
              scan_rounds: Round, pstate, ends: List[int],
              slots: Optional[int] = None,
              budgets: Optional[torch.Tensor] = None,
              ctx: Optional[_ResilientCtx] = None,
              telemetry: bool = False) -> Dict[str, Any]:
    """Tier 3: the host env's (T, S, ...) rounds, one ``block_host`` an
    eval interval (corruption from ``setup.faults`` and its env
    seeds)."""
    dev = setup.base_keys.device
    edge = {k: v.clone() for k, v in setup.edge_seed.items()}
    outs, start = [], 0
    if ctx is not None and ctx.resume:
        res = _try_resume(ctx, {"pstate": pstate, "edge": edge}, dev)
        if res is not None:
            start, carry, outs = res
            pstate, edge = carry["pstate"], carry["edge"]
    lo = ends[start - 1] if start > 0 else 0
    for bi in range(start, len(ends)):
        hi = ends[bi]
        out = _traced_block(
            "fused_block",
            lambda: block_host(pol, setup.spec, pstate, edge,
                               Round(*(f[lo:hi] for f in scan_rounds)),
                               setup.stacked, setup.base_keys, setup.batch,
                               setup.test_x, setup.test_y, slots=slots,
                               budgets=budgets, faults=setup.faults,
                               env_seeds=setup.env_seeds,
                               telemetry=telemetry),
            bi, lo, hi, slots, pol.name, dev)
        pstate, edge = out.policy_state, out.edge_params
        outs.append(out)
        if ctx is not None:
            _after_block(ctx, bi, hi, {"pstate": pstate, "edge": edge}, out)
        lo = hi
    return _collect_blocks(outs, telemetry)


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
