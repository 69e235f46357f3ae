"""Sweep driver of the client-sharded cohort engine (tier 4 on a mesh).

``sweep_sharded`` is ``experiment.sweep.sweep_experiments``' twin for a
``ShardSpec`` that splits the client and/or seed axis over the ranks of
a process group: every rank calls it (SPMD) with the same arguments,
takes its blocks of every input (``topology.shard_layouts``), runs
``engine.sharded_block_device`` an eval interval, and gathers the
outputs, so every rank returns the same ``SweepResult`` in the global
layout. Selections, utilities, participants, explored flags, edge
models and so accuracy and loss are bitwise the dense tier-4 run;
telemetry matches to float tolerance (cross-shard sums reassociate).

What the reference's sharded path refuses, this one refuses alike
(``check_sharded``, which ``repro_torch.run`` calls before any work and
``sweep_sharded`` takes as done): update-corruption faults, a policy
without a row-local ``pair_values`` (the Oracle, Random), a robust
aggregator, an MoE model, a client count or seed count the mesh does
not divide. Like the reference's, it ignores checkpoints, resume and the
health guard.

Scale notes. The slot capacity is the dense engine's: each round's
largest per-ES cohort from the exchanged counts, or ``slots_per_es``
(the reference sizes it by the analytic bound ``slot_capacity``, <= 53
an ES at the mesh presets; the round's own cohort keeps the training
shapes, and so the card's kernels and their rounding, those of the
dense run). Synthetic fallback data is the 16-d ``"tiny"`` kind with 20
samples a client at >= ``TINY_DATA_CLIENTS`` clients, and each rank
stacks only its client rows. The returned selections are dense (S, T,
N) on every rank.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.federated import FederatedDataset
from repro_torch.experiment.sweep import (SweepResult, _block_bounds,
                                          _traced_block, prepare_training)
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch.mesh import rank_device
from repro_torch.mesh.engine import ShardDims, sharded_block_device
from repro_torch.mesh.topology import cohort_mesh, shard_layouts
from repro_torch.obs import trace as obs_trace
from repro_torch.policies.base import FunctionalPolicy
from repro_torch.sim.core import init_statics

TINY_DATA_CLIENTS = 10_000     # synthetic fallback switches to "tiny"


def _validate(device_env: bool, shard, num_clients: int, n_seeds: int,
              model_kind: str) -> None:
    """The reference's ``_validate``: the device env, divisibility, no
    MoE."""
    if not device_env:
        raise ValueError(
            "the sharded cohort engine runs the device-env fused tier "
            "(tier 4) only -- build the env with backend='device' or drop "
            "the ShardSpec")
    if num_clients % shard.clients != 0:
        raise ValueError(
            f"ShardSpec.clients={shard.clients} must divide "
            f"num_clients={num_clients} (pad the cohort or pick a "
            "divisor shard count)")
    if n_seeds % shard.seeds != 0:
        raise ValueError(
            f"ShardSpec.seeds={shard.seeds} must divide the "
            f"{n_seeds} experiment seeds")
    if "moe" in model_kind.lower():
        raise NotImplementedError(
            "MoE models route tokens through top-k, which the reference's "
            "sharded block refuses; use the dense tier")


def check_sharded(policy: FunctionalPolicy, shard, *, device_env: bool,
                  num_clients: int, n_seeds: int, faults, model_kind: str,
                  aggregator: str) -> None:
    """Every refusal of the reference's sharded path
    (``mesh/runner.py::_validate``, ``mesh/engine.py::
    sharded_block_device``), from the run's description alone, so
    ``repro_torch.run`` raises them before any work."""
    _validate(device_env, shard, num_clients, n_seeds, model_kind)
    if faults is not None and faults.corrupt_rate > 0.0:
        raise NotImplementedError(
            "update-corruption faults are not supported by the sharded "
            "cohort engine (client-dense corruption mask)")
    if not hasattr(policy, "pair_values"):
        raise NotImplementedError(
            f"policy {policy.name!r} exposes no row-local pair_values "
            "table; the sharded engine needs one to merge across shards")
    if aggregator != "mean":
        raise NotImplementedError(
            f"aggregator {aggregator!r} sorts per-coordinate slot cohorts, "
            "which the reference's sharded block refuses -- use the dense "
            "tier for robust aggregation")


def _local_policy(pol: FunctionalPolicy, n_local: int) -> FunctionalPolicy:
    """``pol`` over ``n_local`` clients: its ``init`` makes the state of a
    rank's rows (COCS: the dense init's rows, zeros), without the dense
    state."""
    return dataclasses.replace(
        pol, spec=dataclasses.replace(pol.spec, num_clients=n_local))


def sweep_sharded(policies: Dict[str, FunctionalPolicy], env,
                  seeds: Sequence[int], horizon: int, *, shard,
                  model_kind: str = "logreg", batch_size: int = 32,
                  batches_per_epoch: int = 2, eval_every: int = 5,
                  data: Optional[FederatedDataset] = None,
                  slots_per_es: Optional[int] = None,
                  policy_seed_offset: int = 0, aggregator: str = "mean",
                  trim_frac: float = 0.1, telemetry: bool = False,
                  device=None) -> SweepResult:
    """Run tensor policies over ``horizon`` rounds on the cohort mesh
    that ``shard`` (an ``api.ShardSpec``) names; ``sweep_experiments``'
    contract restricted to the device-env fused tier, for a run that
    ``check_sharded`` has passed. Every rank of a process group of
    ``shard.seeds * shard.clients`` ranks calls it; a group of another
    size raises ``ValueError`` saying how to start the ranks."""
    cfg = env.cfg
    seeds = [int(s) for s in seeds]
    dev = resolve_device(device) if device is not None else rank_device()
    mesh = cohort_mesh(shard.seeds, shard.clients)
    if mesh.rank == 0:
        logging.getLogger("repro_torch.mesh").info(
            "cohort mesh: %d seed x %d client shards, %d ranks over %s, "
            "rank 0 on %s", shard.seeds, shard.clients,
            shard.seeds * shard.clients, mesh.backend, dev)
    n = cfg.num_clients
    dims = ShardDims(num_clients=n, n_local=n // shard.clients,
                     seed_shards=shard.seeds, client_shards=shard.clients)
    lo_c = mesh.client * dims.n_local
    s_loc = len(seeds) // shard.seeds
    pol_seeds = [s + int(policy_seed_offset)
                 for s in seeds[mesh.seed * s_loc:(mesh.seed + 1) * s_loc]]

    if data is None and n >= TINY_DATA_CLIENTS:
        with obs_trace.span("data.synthetic_tiny", clients=n):
            data = FederatedDataset.synthetic(n, kind="tiny",
                                              samples_per_client=20, seed=0)
    with obs_trace.span("train.prepare", seeds=len(seeds),
                        model=model_kind, sharded=True):
        # every seed's models and keys, this rank's client rows of data
        setup = prepare_training(cfg, model_kind, batch_size,
                                 batches_per_epoch, data, seeds, dev,
                                 aggregator, trim_frac,
                                 rows=(lo_c, lo_c + dims.n_local))
    with obs_trace.span("mesh.stage", mesh=f"{shard.seeds}x{shard.clients}",
                        backend=mesh.backend):
        (statics,), (edge0, base_keys, seed_t), _, _ = shard_layouts(
            mesh, seed_client=(init_statics(env.spec, setup.env_seeds),),
            seed_only=(setup.edge_seed, setup.base_keys, setup.env_seeds))
        # the rank's rows as tensors of their own: the dense ones go
        statics = type(statics)(*(
            a.clone(memory_format=torch.contiguous_format) for a in statics))
    ends = _block_bounds(horizon, eval_every)
    result = SweepResult(policies=list(policies), seeds=seeds,
                         eval_rounds=np.asarray(ends), accuracy={}, loss={},
                         utilities={}, participants={}, selections={},
                         explored={}, health={}, telemetry={})
    for name, pol in policies.items():
        pstate = _local_policy(pol, dims.n_local).init(s_loc, dev, pol_seeds)
        edge = {k: v.clone() for k, v in edge0.items()}
        pos = statics.pos0.clone()
        outs, lo = [], 0
        for bi, hi in enumerate(ends):
            out = _traced_block(
                "fused_block_device_sharded",
                lambda: sharded_block_device(
                    pol, setup.spec, env.spec, mesh, dims, pstate, edge, pos,
                    seed_t, statics, lo, hi, setup.stacked, base_keys,
                    setup.batch, setup.test_x, setup.test_y,
                    slots=slots_per_es, telemetry=telemetry),
                bi, lo, hi, slots_per_es, name, dev)
            pstate, edge, pos = out.policy_state, out.edge_params, out.env_pos
            outs.append(out)
            lo = hi
        merged = _gather_blocks(outs, mesh, telemetry)
        for f in ("accuracy", "loss", "utilities", "participants",
                  "selections", "explored", "train_loss"):
            getattr(result, f)[name] = merged[f]
        result.telemetry[name] = merged.get("telemetry")
    return result


def _gather_blocks(outs, mesh, telemetry: bool) -> dict:
    """The rank's blocks -> the global run: each field's blocks joined
    along T (or E) on the rank, then assembled over the mesh (the seed
    axis over "seed", the selections' client axis over "clients")."""
    seed_dims = {0: "seed"}
    res = {}
    for f, cat in (("accuracy", False), ("loss", False),
                   ("utilities", True), ("participants", True),
                   ("selections", True), ("explored", True),
                   ("train_loss", True)):
        local = (torch.cat if cat else torch.stack)(
            [getattr(o, f) for o in outs], dim=1)
        dims = {0: "seed", 2: "clients"} if f == "selections" else seed_dims
        res[f] = sharding.assemble(local, mesh, dims,
                                   tag="result").cpu().numpy()
    if telemetry:
        from repro_torch.obs.telemetry import collect
        res["telemetry"] = collect(
            [type(o.telemetry)(*(sharding.assemble(a, mesh, seed_dims,
                                                   tag="result")
                                 for a in o.telemetry)) for o in outs],
            [type(o.tele_acc)(*(sharding.assemble(a, mesh, seed_dims,
                                                  tag="result")
                                for a in o.tele_acc)) for o in outs])
    return res


__all__ = ["TINY_DATA_CLIENTS", "check_sharded", "sweep_sharded"]
