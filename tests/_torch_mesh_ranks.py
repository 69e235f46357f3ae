"""Rank functions of the sharded-engine tests (``spawn_local`` targets).

A spawned rank imports this module and the port, never JAX or the
reference. ``run_layout`` runs each spec through ``repro_torch.run`` on
every rank; with ``probe`` rank 0 also records the output shape of every
op inside the sharded blocks and inside a dense control run
(``torch.utils._python_dispatch.TorchDispatchMode``), for the capacity
contract.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class ShapeLog(TorchDispatchMode):
    """Every op's output shapes while ``on``."""

    def __init__(self):
        super().__init__()
        self.on = False
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.on:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for o in outs:
                if isinstance(o, torch.Tensor):
                    self.shapes.append((str(func), tuple(o.shape)))
        return out


def _logged(fn, log):
    def wrapped(*a, **k):
        log.on = True
        try:
            return fn(*a, **k)
        finally:
            log.on = False
    return wrapped


def pair_tables(shapes, n, m):
    """The ops whose output holds consecutive (n, m) dims: a client-pair
    table (the reference's ``_dense_pair_vars``, with the seed axis)."""
    return [(op, s) for op, s in shapes
            if any(s[i:i + 2] == (n, m) for i in range(len(s) - 1))]


def run_layout(rank, world, device, specs, data, probe=None):
    """Each spec's ``run_specs`` row; with ``probe`` (the dense control
    spec's JSON) rank 0 returns, after the rows, the op shapes of the
    first spec's sharded blocks and of the control's dense blocks."""
    from repro_torch.experiment import sweep
    from repro_torch.launch.mesh import run_specs
    from repro_torch.mesh import runner

    if probe is None or rank != 0:
        return run_specs(rank, world, device, specs, data)
    log = ShapeLog()
    block, dense = runner.sharded_block_device, sweep.block_device
    runner.sharded_block_device = _logged(block, log)
    try:
        with log:
            rows = run_specs(rank, world, device, specs[:1], data)
        sharded = log.shapes
        log.shapes = []
        sweep.block_device = _logged(dense, log)
        with log:
            run_specs(rank, world, device, [probe], data)
    finally:
        runner.sharded_block_device, sweep.block_device = block, dense
    rows += run_specs(rank, world, device, specs[1:], data)
    return rows + [{"sharded": sharded, "dense": log.shapes}]


def run_grid(rank, world, device, spec, budgets, data):
    """A budget grid of the spec (its JSON) through ``repro_torch.run`` on
    every rank: each cell's selections, accuracy and batched axes."""
    import repro_torch
    from repro_torch import api
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.launch.mesh import COLLECTIVES, reset_collectives

    reset_collectives()
    grid = api.ExperimentSpec.from_json(spec).grid(budget=list(budgets))
    res = repro_torch.run(grid, data=FederatedDataset.synthetic(**data),
                          device=device)
    return {"cells": [{"selections": r.selections, "accuracy": r.accuracy,
                       "batched_axes": r.batched_axes} for r in res.results],
            "collectives": dict(COLLECTIVES)}
