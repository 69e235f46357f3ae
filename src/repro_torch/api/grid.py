"""Batched config grids: budget, deadline and hypercube cells next to the
seed axis (a copy of the reference's ``api/grid.py``).

A ``spec.grid(budget=[...], deadline=[...], policy=[...])`` expands into
cells (``api.spec``). This module runs them:

  * cells that differ only in the batchable axes (``budget``,
    ``deadline``; ``h_t``/``alpha`` on the host tier-1 path) are
    flattened cell-major into the batch axis of the engines, ``B = G * S``
    elements, element ``b = g * S + s``, and run as one batched run;
  * any other axis (policy, scenario, model, and the fault and
    robustness axes ``corrupt_rate``, ``dropout_rate`` and
    ``aggregator``) and host-state policies run each cell in turn
    through ``run``, behind the same ``GridResult``. A batched group on
    a faulty env carries its faults: its rounds hold the latency and
    outage events, and each element's updates are corrupted from its
    seed's env seed.

How the batchable axes thread through without a change of shape:

  * **budget** is policy-side only: a (B, M) tensor fed to the solver
    through ``select_with_budgets``;
  * **deadline** only thresholds Eq. 6: each cell's outcomes come from
    the realized Eq. 5 latencies. On the host path this is done in
    float64 before the float32 cast, which gives the rounds a sequential
    run with that deadline realizes; on the device path the in-loop
    float32 comparison is the one a per-cell ``SimSpec`` makes. (``true_p``
    keeps the base deadline's value; no policy reads it to select.)

A batched cell equals the sequential ``run`` of that cell: selections,
utilities, participants and explored bitwise, accuracy to float
tolerance. A batched group carries no telemetry taps, checkpoints or
health guard (its results have ``telemetry`` and ``health`` None), as
the reference's; a cell that runs in turn goes through ``run`` with its
own ``EvalSpec`` and ``ObsSpec``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.run import (RunResult, _check_device, build_env,
                                 build_policy, run, select_tier)
from repro_torch.api.spec import GRID_AXES, ExperimentGrid, ExperimentSpec
from repro_torch.envs import cached_rollout


@dataclass
class GridResult:
    """Per-cell results of a grid run, in expansion order (C order over
    the grid axes, last axis fastest)."""
    grid: ExperimentGrid
    cells: Tuple[ExperimentSpec, ...]
    results: List[RunResult]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.grid.shape

    def __getitem__(self, i: int) -> RunResult:
        return self.results[i]

    def at(self, *idx: int) -> RunResult:
        """Result at integer grid coordinates (one index per axis)."""
        flat = int(np.ravel_multi_index(idx, self.shape))
        return self.results[flat]

    def final_accuracy(self) -> np.ndarray:
        """(grid shape) + (S,) final test accuracies."""
        return np.stack([r.final_accuracy() for r in self.results]
                        ).reshape(self.shape + (-1,))

    def cumulative_utility(self) -> np.ndarray:
        """(grid shape) + (S,) final cumulative utilities."""
        return np.stack([r.cumulative_utility()[:, -1]
                         for r in self.results]).reshape(self.shape + (-1,))


_HYPERCUBE_OPTIONS = ("h_t", "alpha")


def _group_key(cell: ExperimentSpec) -> ExperimentSpec:
    """The cell with its batchable coordinates cleared: cells sharing
    this key differ only in (budget, deadline, h_t, alpha)."""
    opts = tuple((k, v) for k, v in cell.policy.options
                 if k not in _HYPERCUBE_OPTIONS)
    return replace(cell,
                   policy=replace(cell.policy, budget=None, options=opts),
                   env=replace(cell.env, deadline=None))


def run_grid(grid: ExperimentGrid, *, data=None, device=None) -> GridResult:
    """Every cell of ``grid``: batched groups where the cells allow it,
    each other cell through ``run`` (which raises a cell's refusals
    before its work). A batched group runs dense, as the reference's
    does whatever its ``ShardSpec``; its fused tiers split their
    elements over the process group's ranks by ``shard_seeds``, as
    ``sweep_experiments`` splits seeds."""
    from repro_torch.kernels.common import resolve_device

    cells = grid.expand()
    dev = resolve_device(device)
    for cell in cells:
        _check_device(cell, dev)
    batchable = tuple(name for name, _ in grid.axes if GRID_AXES[name][0])
    results: List[Optional[RunResult]] = [None] * len(cells)

    groups: Dict[ExperimentSpec, List[int]] = {}
    for i, cell in enumerate(cells):
        groups.setdefault(_group_key(cell), []).append(i)

    for key, idxs in groups.items():
        group = [cells[i] for i in idxs]
        batched = None
        if batchable and len(group) > 1:
            batched = _run_group_batched(key, group, batchable, data, dev)
        if batched is None:
            for i in idxs:
                results[i] = run(cells[i], data=data, device=dev)
        else:
            for i, r in zip(idxs, batched):
                results[i] = r
    return GridResult(grid=grid, cells=cells, results=results)


def _cocs_grid_params(key_policy, group: List[ExperimentSpec], cfg,
                      horizon: int):
    """Per-cell (h, z) when the group's cells vary only in the COCS
    ``h_t``/``alpha`` knobs, else None: they become per-element data over
    a state padded to ``max(h)`` (``run_rounds_grid_params``)."""
    from repro_torch.policies.cocs import COCS

    if not isinstance(key_policy, COCS):
        return None
    hs, zs = [], []
    for cell in group:
        pol = build_policy(replace(cell.policy, budget=None), cfg, horizon)
        if not isinstance(pol, COCS):
            return None
        if replace(pol, alpha=key_policy.alpha,
                   h_t=key_policy.h_t) != key_policy:
            return None          # differs beyond the hypercube knobs
        z, h = pol._params()
        hs.append(int(h))
        zs.append(float(z))
    return np.asarray(hs, np.int32), np.asarray(zs, np.float32)


def _run_group_batched(key: ExperimentSpec, group: List[ExperimentSpec],
                       batchable: Tuple[str, ...], data, dev
                       ) -> Optional[List[RunResult]]:
    """One batched run for a group of cells, or None when the group
    cannot batch (a host-state policy, or hypercube axes off the host
    tier-1 path)."""
    from repro_torch.sim.draws import SCHEDULE_ID
    from repro_torch.sim.spec import DeviceEnv

    env = build_env(key.env)
    cfg = env.cfg
    policy = build_policy(key.policy, cfg, key.horizon)
    tier = select_tier(key, policy, env)
    if not policy.tensor_capable:
        return None
    device = isinstance(env, DeviceEnv)
    params = None
    if any(replace(c.policy, budget=None) != key.policy for c in group):
        # hypercube (h_t/alpha) axes batch on the tier-1 host path only
        if tier != 1 or device:
            return None
        params = _cocs_grid_params(policy, group, cfg, key.horizon)
        if params is None:
            return None
    seeds = [int(s) for s in key.seeds]
    pol_seeds = [s + key.policy.seed_offset for s in seeds]
    n_seeds = len(seeds)
    budgets = np.asarray([c.policy.budget if c.policy.budget is not None
                          else cfg.budget for c in group], np.float32)
    deadlines = np.asarray([c.env.deadline if c.env.deadline is not None
                            else cfg.deadline_s for c in group], np.float32)
    # flatten cell-major: element b = g * S + s
    budgets_b = np.repeat(budgets, n_seeds)
    deadlines_b = np.repeat(deadlines, n_seeds)
    pol_seeds_b = [int(x) for x in np.tile(np.asarray(pol_seeds, np.int64),
                                           len(group))]
    if tier == 1:
        out = _bandit_grid(policy, env, device, seeds, pol_seeds_b,
                           key.horizon, budgets_b, deadlines_b, len(group),
                           dev, params=params)
        eval_block = None
    else:
        out, eval_block = _fused_grid(key, policy, env, device, seeds,
                                      pol_seeds_b, budgets_b, deadlines_b,
                                      len(group), data, dev)
    results = []
    for g, cell in enumerate(group):
        lo, hi = g * n_seeds, (g + 1) * n_seeds
        rr = RunResult(
            spec=cell, tier=tier,
            env_backend="device" if device else "host",
            draw_schedule=SCHEDULE_ID,
            selections=out["selections"][lo:hi],
            utilities=out["utilities"][lo:hi],
            participants=out["participants"][lo:hi],
            explored=out["explored"][lo:hi],
            batched_axes=batchable)
        if eval_block is not None:
            rr.eval_rounds = eval_block["eval_rounds"]
            rr.accuracy = eval_block["accuracy"][lo:hi]
            rr.loss = eval_block["loss"][lo:hi]
        results.append(rr)
    return results


# -- grid round batches ------------------------------------------------------


def _host_grid_batch(env, seeds, horizon: int, deadlines_cells):
    """(B, T, ...) numpy ``Round`` batch of the host env, cell-major, each
    cell's Eq. 6 outcomes recomputed in float64 from the realized Eq. 5
    latencies (latencies, costs, contexts and eligibility do not depend
    on the deadline)."""
    from repro_torch.policies.base import Round

    base = env.rollout_multi(seeds, horizon)               # (S, T, ...)
    lat64 = np.stack([[rd.latency for rd in cached_rollout(env, s, horizon)]
                      for s in seeds])                     # (S, T, N, M)
    cells = [base._replace(outcomes=(lat64 <= float(d)).astype(np.float32))
             for d in deadlines_cells]
    return Round(*(np.concatenate(f) for f in zip(*cells)))


def _bandit_grid(policy, env, device: bool, seeds, pol_seeds_b,
                 horizon: int, budgets_b, deadlines_b, n_cells: int, dev,
                 params=None):
    """Tier-1 grid: one run over the flattened (cell, seed) elements.
    ``params`` carries per-cell COCS (h, z) (host path only)."""
    from repro_torch.policies import run_rounds_grid, run_rounds_grid_params
    from repro_torch.policies.base import round_from_arrays

    if device:
        from repro_torch.sim.engine import run_bandit_device_grid
        seeds_b = [int(x) for x in np.tile(np.asarray(seeds), n_cells)]
        return run_bandit_device_grid(policy, env.spec, seeds_b, budgets_b,
                                      deadlines_b, horizon, pol_seeds_b,
                                      device=dev)
    deadlines_cells = deadlines_b[::len(seeds)]
    batch = round_from_arrays(
        _host_grid_batch(env, seeds, horizon, deadlines_cells), dev)
    if params is not None:
        hs, zs = params
        return run_rounds_grid_params(
            policy, batch, budgets_b, np.repeat(hs, len(seeds)),
            np.repeat(zs, len(seeds)), pol_seeds_b)
    return run_rounds_grid(policy, batch, budgets_b, pol_seeds_b)


# -- fused training grid -----------------------------------------------------


def _fused_grid(key: ExperimentSpec, policy, env, device: bool, seeds,
                pol_seeds_b, budgets_b, deadlines_b, n_cells: int, data,
                dev):
    """Tiers 3 and 4 over the flattened grid: the sweep engine's blocks
    with the cells folded into the batch axis, every element starting
    from its seed's model, sampler key and env. Returns (per-round outs
    with (B, ...) arrays, eval dict)."""
    from repro_torch.experiment.sweep import (_block_bounds,
                                              gather_objects,
                                              prepare_training, run_fused,
                                              run_fused_device, seed_split)
    from repro_torch.policies.base import (round_from_arrays,
                                           rounds_to_scan_axes)
    from repro_torch.policies.engine import full_budgets
    from repro_torch.sim.core import init_statics

    train = key.train
    setup = prepare_training(
        env.cfg, train.model_kind, train.batch_size,
        train.batches_per_epoch, data, seeds, dev, train.aggregator,
        train.trim_frac, env.spec.faults if device else env.faults)

    def tile(a: torch.Tensor) -> torch.Tensor:
        return a.repeat((n_cells,) + (1,) * (a.dim() - 1))

    # each cell repeats its seeds' models, sampler keys and env seeds
    # (the env seeds draw the update corruption); with ``shard_seeds``
    # over a process group each rank runs its block of the elements
    b_total = len(pol_seeds_b)
    split = seed_split(b_total, key.shard_seeds)
    rank, k = split if split is not None else (0, 1)
    mine = slice(rank * b_total // k, (rank + 1) * b_total // k)
    setup = setup._replace(
        edge_seed={n: tile(v)[mine] for n, v in setup.edge_seed.items()},
        base_keys=tile(setup.base_keys)[mine],
        env_seeds=tile(setup.env_seeds)[mine])
    ends = _block_bounds(key.horizon, key.eval.eval_every)
    budgets = full_budgets(policy, budgets_b, dev)[mine]
    pstate = policy.init(len(pol_seeds_b[mine]), dev, pol_seeds_b[mine])
    if device:
        seed_t = setup.env_seeds
        out = run_fused_device(
            policy, setup, env.spec, seed_t, init_statics(env.spec, seed_t),
            pstate, ends, train.slots_per_es, budgets,
            torch.as_tensor(deadlines_b[mine], device=dev))
    else:
        batch = _host_grid_batch(env, seeds, key.horizon,
                                 deadlines_b[::len(seeds)])
        batch = type(batch)(*(f[mine] for f in batch))
        out = run_fused(policy, setup,
                        round_from_arrays(rounds_to_scan_axes(batch), dev),
                        pstate, ends, train.slots_per_es, budgets)
    fields = ("selections", "utilities", "participants", "explored",
              "accuracy", "loss")
    out = {f: out[f] for f in fields}
    if split is not None:
        parts = gather_objects(out)
        out = {f: np.concatenate([p[f] for p in parts]) for f in fields}
    return ({f: out[f] for f in fields[:4]},
            {"eval_rounds": np.asarray(ends), "accuracy": out["accuracy"],
             "loss": out["loss"]})


__all__ = ["GridResult", "run_grid"]
