"""The client-sharded tier-4 block over the cohort mesh.

A block covers one eval interval with ``experiment.fused.block_device``'s
stages in its order, but every client-indexed tensor is this rank's
``(S_local, n_local, ...)`` block:

* the env from the shard draws (``sim.draws.shard_round_draws``, bitwise
  rows of the dense stream) through the dense ``sim_round`` on the
  rank's rows;
* select and update: COCS's ``pair_values`` on the rank's rows, the
  hierarchical walk (``mesh.select.shard_assign``), bitwise the dense
  assignment; the ``explored`` flag OR-reduced over the clients group;
* the sharded pack (``experiment.packing.pack_assignment_sharded``):
  the dense packed cohort, replicated, with the dense slot capacity;
* the slot batches: each rank gathers the rows of the slots it owns and
  an ``all_gather`` takes each slot's from its owner, bitwise the dense
  gather (padding slots are client 0's, owned by the first shard);
* ``fed.batched.train_packed`` on the replicated cohort: local SGD, the
  dense Eq. 6 mask, Eq. 3 (B3), the cloud sync, then the block-end eval,
  identical on every rank of a seed row, so the edge models are the
  dense ones bit for bit.

No op inside a round outputs an (N, M) client-pair table of the global
N, only the rank's (n_local, M) ones (``tests/test_torch_mesh_engine.py``
records every op's output shape).
The reference's refusals (``mesh.runner.check_sharded``) are raised before
any work.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core.fmath import mul_rcp, sqrt_rn
from repro_torch.experiment.fused import (BlockOut, RoundOut, _block_out,
                                          block_eval)
from repro_torch.experiment.packing import pack_assignment_sharded
from repro_torch.fed.batched import (BatchedRoundSpec, device_batch_indices,
                                     train_packed)
from repro_torch.launch.mesh import CohortMesh, all_gather, all_reduce
from repro_torch.mesh.select import shard_assign
from repro_torch.obs.telemetry import (TelemetryFrame, acc_init, acc_update,
                                       aggregator_adjusted)
from repro_torch.policies.base import FunctionalPolicy
from repro_torch.sim import draws
from repro_torch.sim.core import SimStatics, sim_round
from repro_torch.sim.spec import SimSpec


class ShardDims(NamedTuple):
    """Static shape facts of one sharded block."""
    num_clients: int     # global N
    n_local: int         # N / client_shards
    seed_shards: int
    client_shards: int


def _slot_batches(stacked, ci: torch.Tensor, idx: torch.Tensor, base: int,
                  n_local: int, group):
    """The slot batches of the replicated cohort from client-sharded
    data: ``stacked`` holds this rank's rows; each rank gathers the
    slots whose client it owns (zeros elsewhere), an ``all_gather`` over
    ``group`` collects them, and each slot takes its owner's."""
    own = (ci >= base) & (ci < base + n_local)                # (S, M, cap)
    cl = torch.clamp(ci.long() - base, 0, n_local - 1)[..., None, None]
    il = idx.long()
    owner = (ci.long() // n_local)[None]                      # in the group
    out = []
    for a in (stacked.x, stacked.y):
        part = a[cl, il]
        mask = own.view(own.shape + (1,) * (part.dim() - own.dim()))
        part = torch.where(mask, part, torch.zeros_like(part))
        g = all_gather(part, group, tag="batches")
        at = owner.view(owner.shape + (1,) * (part.dim() - own.dim()))
        out.append(torch.take_along_dim(g, at, dim=0)[0])
    return out


def _shard_frame(policy, pstate, rd, assign: torch.Tensor, taps: dict,
                 spec: BatchedRoundSpec, group) -> TelemetryFrame:
    """``obs.telemetry.round_frame`` with the client-axis sums reduced
    over ``group``: the policy tap and the selection and spend sums see
    the rank's rows; the slot-shaped taps are replicated. Float sums
    reassociate across shards, so the frame matches the dense one to
    float tolerance (the decisions stay bitwise)."""
    s = assign.shape[0]
    m = taps["w"].shape[1]
    zeros = torch.zeros((s,), dtype=torch.float32, device=assign.device)
    sel = assign >= 0
    costs = rd.costs.to(torch.float32)
    local = [sel.sum(dim=1).to(torch.float32),
             torch.where(sel, costs, torch.zeros_like(costs)).sum(dim=1)]
    if hasattr(policy, "telemetry_sums"):
        sums = policy.telemetry_sums(pstate, rd)
        local += [sums["width_sum"].to(torch.float32),
                  sums["eligible"].to(torch.float32),
                  sums["under"].to(torch.float32)]
    red = all_reduce(torch.stack(local), "sum", group, tag="frame")
    selected, spent = red[0], red[1]
    if len(local) > 2:
        ucb_width = red[2] / torch.clamp(red[3], min=1)
        under = red[4]
    else:
        ucb_width, under = zeros, zeros
    total = torch.full((s,), float(policy.spec.budget) * m,
                       dtype=torch.float32, device=assign.device)
    v = taps["valid"] > 0
    a = (taps["arrived"] > 0) & v
    w, slot_sq = taps["w"], taps["slot_sq"]
    return TelemetryFrame(
        ucb_width=ucb_width, underexplored=under,
        budget_util=spent / torch.clamp(total, min=1e-12),
        selected=selected, arrived=a.sum(dim=(1, 2)).to(torch.float32),
        deadline_miss=(v & ~a).sum(dim=(1, 2)).to(torch.float32),
        delta_norm=torch.sqrt((slot_sq * (w > 0).to(torch.float32))
                              .sum(dim=(1, 2))),
        agg_adjusted=aggregator_adjusted(spec.aggregator,
                                         float(spec.trim_frac), w,
                                         torch.sqrt(slot_sq)),
        corrupted=zeros)


def sharded_block_device(policy: FunctionalPolicy, spec: BatchedRoundSpec,
                         sim_spec: SimSpec, mesh: CohortMesh,
                         dims: ShardDims, pstate,
                         edge: Dict[str, torch.Tensor], env_pos: torch.Tensor,
                         seeds: torch.Tensor, statics: SimStatics, lo: int,
                         hi: int, stacked, base_keys: torch.Tensor,
                         batch: int, test_x: torch.Tensor,
                         test_y: torch.Tensor, slots: Optional[int] = None,
                         telemetry: bool = False) -> BlockOut:
    """Rounds ``lo .. hi-1`` of this rank's block, then one evaluation:
    ``block_device``'s contract on the rank's seeds (``seeds``,
    ``pstate``, ``edge``, ``base_keys`` are its (S_local, ...) blocks)
    and rows (``env_pos``, ``statics``, ``pstate`` and ``stacked``'s
    ``x``/``y`` its client rows; ``stacked.sizes`` the global (N,)
    vector). Returns the rank's ``BlockOut``: selections (S_local, T,
    n_local), everything else per seed."""
    n, n_local = dims.num_clients, dims.n_local
    m, group = spec.num_edge_servers, mesh.clients_group
    base = mesh.client * n_local
    faults = sim_spec.faults
    faulty = faults is not None and faults.enabled
    k_mc = 0 if sim_spec.true_p == "analytic" else sim_spec.mc_true_p
    dev = seeds.device
    budgets = policy.spec.budgets_like(seeds[:, None])
    sqrt_u = policy.spec.sqrt_utility
    outs, pos = [], env_pos
    tacc = acc_init(seeds.shape[0], dev) if telemetry else None
    for t in range(lo, hi):
        dr = draws.shard_round_draws(seeds, t, n, m, k_mc, base, n_local,
                                     dev)
        fd = (draws.shard_fault_draws(seeds, t, n, m, base, n_local, dev,
                                      faults.env_fields)
              if faulty else None)
        pos, sr = sim_round(sim_spec, seeds, statics, pos, t, dr=dr, fd=fd)
        rd = sr.round
        values, under = policy.pair_values(pstate, rd)
        assign = shard_assign(values, rd.costs.to(values.dtype),
                              rd.eligible, budgets, group=group,
                              num_clients=n, base=base, sqrt_utility=sqrt_u)
        explored = all_reduce(under.any(dim=2).any(dim=1).to(torch.int32),
                              "max", group, tag="explored") > 0
        new_pstate = policy.update(pstate, rd, assign,
                                   {"explored": explored})
        ci, valid, arrived, tau = pack_assignment_sharded(
            assign, rd.outcomes, rd.latency, m, slots, group, base)
        idx = device_batch_indices(base_keys, rd.t, ci, stacked.sizes,
                                   spec.steps, batch)
        xb, yb = _slot_batches(stacked, ci, idx, base, n_local, group)
        trained = train_packed(spec, edge, ci, valid, arrived, tau, xb, yb,
                               rd.t, taps=telemetry)
        edge, parts, train_loss = trained[:3]
        util = sqrt_rn(mul_rcp(parts, m)) if sqrt_u else parts
        frame = None
        if telemetry:
            frame = _shard_frame(policy, pstate, rd, assign, trained[3],
                                 spec, group)
            tacc = acc_update(tacc, frame, explored)
        pstate = new_pstate
        outs.append(RoundOut(assign, util, parts, explored, train_loss,
                             frame))
    acc, loss = block_eval(edge, test_x, test_y, spec.model)
    return _block_out(pstate, edge, pos, outs, acc, loss, tacc)
