"""The HFL network simulator on tensors: Eq. 4-6 context realization,
batched over seeds.

One round mirrors the reference's ``sim_round`` stage for stage:
mobility update, client-ES association (with the stranded-client fix),
the fused Eq. 4/5 pairwise stage (``kernels.context_pairwise``: one CUDA
launch for all seeds), Eq. 6 deadline outcomes, tiered costs, flash-crowd
surge pricing, bursty availability, context normalization and
``true_p``: the Monte-Carlo estimate, or the analytic Eq. 6 integral
(``sim.truep``), which draws no fading pairs. It consumes the same
counter-based draws (``sim.draws``) and repeats the float32 arithmetic
as the reference executes it under ``jit`` (``core.fmath``), so a round
matches the reference pointwise: costs and positions bitwise, the
transcendental stages to a few ulp.

Every function takes a leading seed axis ``S`` on its per-client tensors
(the reference's ``vmap``); ``seeds`` is an int tensor ``(S,)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.fmath import fma, fold, mul_rcp, rcp
from repro_torch.core.network import es_positions
from repro_torch.kernels.context_pairwise.ops import pairwise_context
from repro_torch.kernels.context_pairwise.ref import latency
from repro_torch.policies.base import Round
from repro_torch.sim import draws
from repro_torch.sim.faults import apply_latency_faults, apply_outage
from repro_torch.sim.spec import SimSpec
from repro_torch.sim.truep import analytic_true_p


class SimStatics(NamedTuple):
    """Experiment-lifetime per-client tensors (float32), (S, N, ...)."""
    pos0: torch.Tensor           # (S, N, 2) initial positions
    price: torch.Tensor          # (S, N)
    base_bw: torch.Tensor        # (S, N)
    base_comp: torch.Tensor      # (S, N)
    surge_mask: torch.Tensor     # (S, N) bool — flash-crowd cohort
    arrival_phase: torch.Tensor  # (S, N) int32 — bursty-arrival phase


class SimRound(NamedTuple):
    """One realized round: the policy-facing ``Round`` plus the
    per-client resource vectors."""
    round: Round
    compute: torch.Tensor        # (S, N)
    bandwidth: torch.Tensor      # (S, N)


def es_table(spec: SimSpec, device) -> torch.Tensor:
    return torch.as_tensor(es_positions(spec.num_edge_servers),
                           dtype=torch.float32, device=device)


def init_statics(spec: SimSpec, seeds: torch.Tensor) -> SimStatics:
    """Per-seed statics from the init draws (float32 math)."""
    n = spec.num_clients
    di = draws.init_draws(seeds, n, seeds.device)
    pos0 = fma(di.pos_u, 2.0 * spec.area, -spec.area)
    if spec.price_tier_values is not None:
        edges = torch.tensor(spec.price_tier_edges, dtype=torch.float32,
                             device=seeds.device)
        values = torch.tensor(spec.price_tier_values, dtype=torch.float32,
                              device=seeds.device)
        idx = torch.searchsorted(edges, di.price_u.contiguous(),
                                 right=True)
        price = values[torch.clamp(idx, max=len(values) - 1)]
    else:
        price = fma(di.price_u, spec.price_high - spec.price_low,
                    spec.price_low)
    base_bw = fma(di.bw_u, spec.bandwidth_high - spec.bandwidth_low,
                  spec.bandwidth_low)
    base_comp = fma(di.comp_u, spec.compute_high - spec.compute_low,
                    spec.compute_low)
    surge_mask = torch.zeros_like(di.perm, dtype=torch.bool)
    if spec.surge_count > 0:
        surge_mask.scatter_(-1, di.perm[..., :spec.surge_count].long(),
                            True)
    if spec.arrival_period > 0:
        phase = torch.clamp((di.phase_u * spec.arrival_period)
                            .to(torch.int32), max=spec.arrival_period - 1)
    else:
        phase = torch.zeros_like(di.phase_u, dtype=torch.int32)
    return SimStatics(pos0=pos0, price=price, base_bw=base_bw,
                      base_comp=base_comp, surge_mask=surge_mask,
                      arrival_phase=phase)


def sim_round(spec: SimSpec, seeds: torch.Tensor, statics: SimStatics,
              pos: torch.Tensor, t: int,
              dr: Optional[draws.RoundDraws] = None,
              fd: Optional[draws.FaultDraws] = None
              ) -> Tuple[torch.Tensor, SimRound]:
    """One round for all seeds: ``(pos, t) -> (pos', round)``.

    ``dr``/``fd`` override the internally derived round and fault draws
    (tests feed the reference's through them). The spec's faults act
    after bursty arrival and before the Eq. 6 outcomes: latency faults
    on ``tau``, outages on the eligibility; ``true_p`` stays
    fault-free, as the reference's."""
    n, m = pos.shape[-2], spec.num_edge_servers
    dev = pos.device
    analytic = spec.true_p == "analytic"
    if dr is None:
        # the analytic mode draws no Monte-Carlo pairs; draws are
        # addressed by tag, so no other stream moves
        dr = draws.round_draws(seeds, t, n, m,
                               0 if analytic else spec.mc_true_p, dev)
    pos = torch.clamp(fma(spec.mobility, dr.move, pos), -spec.area,
                      spec.area)
    bandwidth = torch.clamp(statics.base_bw * fma(spec.jitter, dr.bw_n, 1.0),
                            spec.bandwidth_low, spec.bandwidth_high)
    compute = torch.clamp(statics.base_comp * fma(spec.jitter, dr.comp_n,
                                                  1.0),
                          spec.compute_low, spec.compute_high)
    d, g0, mean_rate, tau = pairwise_context(
        pos, es_table(spec, dev), bandwidth, compute, dr.fad_dt, dr.fad_ut,
        tx_w=spec.tx_w, noise_psd_w=spec.noise_psd_w,
        update_bits=spec.update_bits, workload=spec.workload)
    eligible = d <= spec.cell_radius_km
    # stranded fix: a client covering no ES is attached to the nearest
    # one (argmin takes the first index on ties, as the reference's)
    nearest = torch.nn.functional.one_hot(torch.argmin(d, dim=-1),
                                          m).bool()
    eligible = eligible | (~eligible.any(dim=-1, keepdim=True) & nearest)
    spend = 2.0 * statics.price * bandwidth
    costs = mul_rcp(spend, 1e6)
    if spec.surge_period > 0 and t % spec.surge_period < spec.surge_len:
        # XLA folds the discount into the reciprocal of 1e6
        costs = torch.where(statics.surge_mask,
                            spend * fold(rcp(1e6), spec.surge_discount),
                            costs)
    if spec.arrival_period > 0:
        active = ((t - statics.arrival_phase) % spec.arrival_period
                  < spec.arrival_len)
        eligible = eligible & active[..., None]
    faults = spec.faults
    if faults is not None and faults.enabled:
        if fd is None:
            fd = draws.fault_draws(seeds, t, n, m, dev, faults.env_fields)
        tau = apply_latency_faults(faults, tau, fd.strag_u, fd.strag_e,
                                   fd.drop_u)
        eligible = apply_outage(faults, eligible, fd.out_u)
    outcomes = (tau <= spec.deadline_s).to(torch.float32)
    phi_rate = torch.clamp(mul_rcp(mean_rate, spec.rate_hi), 0.0, 1.0)
    phi_comp = mul_rcp(compute - spec.compute_low,
                       spec.compute_high - spec.compute_low)
    contexts = torch.stack(
        [phi_rate, phi_comp[..., None].expand_as(phi_rate)], dim=-1)
    if analytic:
        true_p = analytic_true_p(
            bandwidth[..., None], compute[..., None], g0, tx_w=spec.tx_w,
            noise_psd_w=spec.noise_psd_w, update_bits=spec.update_bits,
            workload=spec.workload, deadline_s=spec.deadline_s)
    else:
        tau_mc = latency(bandwidth[..., None, :, None],
                         compute[..., None, :, None], dr.mc_dt, dr.mc_ut,
                         g0[..., None, :, :], tx_w=spec.tx_w,
                         noise_psd_w=spec.noise_psd_w,
                         update_bits=spec.update_bits,
                         workload=spec.workload)
        # a mean of 0/1 values over K: exact in float32 in any order
        true_p = (tau_mc <= spec.deadline_s).to(torch.float32).mean(
            dim=-3)
    t_arr = torch.full(pos.shape[:-2], int(t), dtype=torch.int32,
                       device=dev)
    rd = Round(t=t_arr, contexts=contexts, eligible=eligible, costs=costs,
               outcomes=outcomes, true_p=true_p, latency=tau)
    return pos, SimRound(round=rd, compute=compute, bandwidth=bandwidth)


def round_batch(spec: SimSpec, seeds: torch.Tensor, statics: SimStatics,
                pos: torch.Tensor, t: int) -> Tuple[torch.Tensor, Round]:
    """Seed-batched round generation for the training loop: returns
    ``(pos', Round)`` with (S, ...) leaves."""
    pos, sr = sim_round(spec, seeds, statics, pos, t)
    return pos, sr.round
