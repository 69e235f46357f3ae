"""HFL wireless network simulator (Section III + VI-A of the paper), the
host env: a float64 numpy copy of the reference's ``core/network.py``.

Models, per edge-aggregation round:
  * client mobility (random waypoint walk) -> time-varying client-ES
    eligibility (coverage radius) and distances;
  * per-round available compute y_n and bandwidth b_n, jittered around
    a persistent per-client profile;
  * downlink/uplink channel: path loss 128.1 + 37.6 log10(d_km) with Rayleigh
    small-scale fading; Shannon rate r = b log2(1 + P g / N0)  (Eq. 4);
  * training latency tau = a_DT/r_DT + q/y + a_UT/r_UT            (Eq. 5);
  * deadline outcome X = 1{tau <= tau_dead}                        (Eq. 6);
  * rental cost c_n(y_n) = price_n * y_n (price ~ U[0.5, 2] per MHz).

Contexts exposed to policies: phi = (normalized downlink rate, normalized
compute) in [0, 1]^2.

Randomness comes from the counter-based schedule in ``sim.draws``,
addressed by ``(seed, t)``: the same float32 draws feed this float64
simulator and the float32 device simulator (``sim.core``), so the two
realize the same rounds to float tolerance. ``round(t)`` is pure in its
randomness: only the mobility positions are carried state. The channel
constants below are also the device simulator's starting values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.paper_hfl import HFLExperimentConfig
from repro_torch.sim.draws import host_init_draws, host_round_draws


@dataclass
class RoundData:
    t: int
    contexts: np.ndarray    # (N, M, 2) in [0,1]^2
    eligible: np.ndarray    # (N, M) bool
    costs: np.ndarray       # (N,)
    outcomes: np.ndarray    # (N, M) realized X (0/1)
    true_p: np.ndarray      # (N, M) ground-truth participation probability
    compute: np.ndarray     # (N,) y_n (Hz proxy)
    bandwidth: np.ndarray   # (N,)
    latency: Optional[np.ndarray] = None    # (N, M) realized tau (Eq. 5), s


def _dbm_to_watt(dbm: float) -> float:
    return 10 ** (dbm / 10.0) / 1000.0


def es_positions(num_es: int) -> np.ndarray:
    """ES positions on a circle of radius 1.5 km (float64)."""
    ang = np.linspace(0, 2 * np.pi, num_es, endpoint=False)
    return np.stack([1.5 * np.cos(ang), 1.5 * np.sin(ang)], -1)


def path_loss_gain(d_km, floor_km: float = 0.01):
    """Linear distance-only channel gain: 128.1 + 37.6 log10(d) dB
    (float64 numpy)."""
    pl_db = 128.1 + 37.6 * np.log10(np.maximum(d_km, floor_km))
    return 10.0 ** (-pl_db / 10.0)


def context_rate_hi(cfg: HFLExperimentConfig) -> float:
    """Context-normalization constant (min-max scaling, Sec. IV): the
    Eq. 4 rate at bandwidth_high, d = 0.05 km, |h|^2 = 4, in float64."""
    g = 4.0 * path_loss_gain(0.05)
    snr = (_dbm_to_watt(cfg.tx_power_dbm) * g
           / (_dbm_to_watt(cfg.noise_dbm_per_hz) * cfg.bandwidth_high))
    return float(cfg.bandwidth_high * np.log2(1.0 + snr))


class HFLNetworkSim:
    """Deterministic given (cfg, seed). One call to ``round(t)`` per round.

    ``faults`` (a ``sim.faults.FaultSpec``) injects dropout, straggler
    and outage events from the shared fault draws, the same events as
    the device env's (corruption is the training round's)."""

    def __init__(self, cfg: HFLExperimentConfig, seed: int = 0,
                 mc_true_p: int = 128, mobility: float = 0.15,
                 jitter: float = 0.30, true_p_mode: str = "mc",
                 faults=None):
        if true_p_mode not in ("mc", "analytic"):
            raise ValueError(f"unknown true_p mode {true_p_mode!r}")
        self.cfg = cfg
        self.seed = int(seed)
        self.mobility = mobility
        self.mc_true_p = mc_true_p
        self.true_p_mode = true_p_mode
        self.faults = faults
        n, m = cfg.num_clients, cfg.num_edge_servers
        # ES positions on a circle; area = bounding box of coverage discs
        self.es_pos = es_positions(m)
        self.area = 1.5 + cfg.cell_radius_km
        di = host_init_draws(self.seed, n)
        self.init_draws = di
        self.client_pos = -self.area + di.pos_u * (2.0 * self.area)
        self.price = cfg.price_low + di.price_u * (cfg.price_high
                                                   - cfg.price_low)
        # persistent per-client resource profile; per-round availability
        # jitters around it, which makes contexts informative
        self.base_bw = cfg.bandwidth_low + di.bw_u * (cfg.bandwidth_high
                                                      - cfg.bandwidth_low)
        self.base_comp = cfg.compute_low + di.comp_u * (cfg.compute_high
                                                        - cfg.compute_low)
        self.jitter = jitter
        self.noise_psd_w = _dbm_to_watt(cfg.noise_dbm_per_hz)
        self.tx_w = _dbm_to_watt(cfg.tx_power_dbm)
        # context normalization ranges (min-max feature scaling, Sec. IV)
        self._rate_hi = context_rate_hi(cfg)
        self._rate_lo = 0.0

    # -- channel helpers ----------------------------------------------------

    def _gain0(self, d_km: np.ndarray) -> np.ndarray:
        """Distance-only part of the channel gain (path loss, linear)."""
        return path_loss_gain(np.asarray(d_km, float))

    def _gain(self, d_km, fading: np.ndarray,
              g0: Optional[np.ndarray] = None) -> np.ndarray:
        """Linear channel gain: path loss (dB) + Rayleigh |h|^2 ~ Exp(1).
        ``g0`` reuses the path-loss term across a round's fading draws."""
        if g0 is None:
            g0 = self._gain0(d_km)
        return np.asarray(fading, float) * g0

    def _rate(self, bandwidth, d_km, fading,
              g0: Optional[np.ndarray] = None) -> np.ndarray:
        g = self._gain(d_km, fading, g0)
        snr = self.tx_w * g / (self.noise_psd_w * np.asarray(bandwidth, float))
        return bandwidth * np.log2(1.0 + snr)

    def _latency(self, bandwidth, compute, d_km, fad_dt, fad_ut,
                 g0: Optional[np.ndarray] = None) -> np.ndarray:
        c = self.cfg
        r_dt = self._rate(bandwidth, d_km, fad_dt, g0)
        r_ut = self._rate(bandwidth, d_km, fad_ut, g0)
        with np.errstate(divide="ignore"):
            return (c.update_bits / np.maximum(r_dt, 1e-9)
                    + c.workload / np.maximum(compute, 1e-9)
                    + c.update_bits / np.maximum(r_ut, 1e-9))

    # -- per-round sampling ---------------------------------------------------

    def _move_clients(self, move):
        step = self.mobility * move
        self.client_pos = np.clip(self.client_pos + step,
                                  -self.area, self.area)

    def round(self, t: int) -> RoundData:
        c = self.cfg
        n, m = c.num_clients, c.num_edge_servers
        analytic = self.true_p_mode == "analytic"
        # analytic true_p consumes no MC fading pairs; tags are
        # counter-based so every other draw stream is unchanged
        dr = host_round_draws(self.seed, t, n, m,
                              0 if analytic else self.mc_true_p)
        self._move_clients(dr.move)
        d = np.linalg.norm(self.client_pos[:, None] - self.es_pos[None],
                           axis=-1)                           # (N, M) km
        eligible = d <= c.cell_radius_km
        # nobody is stranded: a client covering no ES takes the nearest
        stranded = ~eligible.any(axis=1)
        if stranded.any():
            eligible[stranded, np.argmin(d[stranded], axis=1)] = True
        bandwidth = np.clip(self.base_bw * (1 + self.jitter * dr.bw_n),
                            c.bandwidth_low, c.bandwidth_high)
        compute = np.clip(self.base_comp * (1 + self.jitter * dr.comp_n),
                          c.compute_low, c.compute_high)
        # rental price per MHz of the resources the client brings this
        # round; cost_scale 2 / 1e6 lets B = 3.5 admit ~2-3 clients per ES
        costs = 2.0 * self.price * bandwidth / 1e6
        # realized fading for this round; the path-loss gain is
        # distance-only, computed once per round
        g0 = self._gain0(d)
        tau = self._latency(bandwidth[:, None], compute[:, None], d,
                            dr.fad_dt, dr.fad_ut, g0)
        if self.faults is not None and self.faults.enabled:
            # the float32 fault draws as float64; each threshold
            # downcasts them again (sim.faults._hit)
            from repro_torch.sim.draws import host_fault_draws
            from repro_torch.sim.faults import (apply_latency_faults,
                                                apply_outage)
            fd = host_fault_draws(self.seed, t, n, m,
                                  self.faults.env_fields)
            tau = apply_latency_faults(self.faults, tau, fd.strag_u,
                                       fd.strag_e, fd.drop_u)
            eligible = apply_outage(self.faults, eligible, fd.out_u)
        outcomes = (tau <= c.deadline_s).astype(np.float64)
        # contexts: (normalized mean downlink rate, normalized compute)
        mean_rate = self._rate(bandwidth[:, None], d, 1.0, g0)  # E[|h|^2]=1
        phi_rate = np.clip(mean_rate / self._rate_hi, 0.0, 1.0)
        phi_comp = (compute - c.compute_low) / (c.compute_high - c.compute_low)
        contexts = np.stack(
            [phi_rate, np.broadcast_to(phi_comp[:, None], (n, m))], axis=-1)
        # ground-truth participation probability: the exact Eq. 6
        # integral (sim.truep, float64 here) or Monte Carlo over fading
        if analytic:
            from repro_torch.sim.truep import host_analytic_true_p
            true_p = host_analytic_true_p(
                bandwidth[:, None], compute[:, None], g0, tx_w=self.tx_w,
                noise_psd_w=self.noise_psd_w, update_bits=c.update_bits,
                workload=c.workload, deadline_s=c.deadline_s)
        else:
            tau_mc = self._latency(bandwidth[None, :, None],
                                   compute[None, :, None], d[None],
                                   dr.mc_dt, dr.mc_ut, g0)
            true_p = (tau_mc <= c.deadline_s).mean(axis=0)
        return RoundData(t=t, contexts=contexts, eligible=eligible,
                         costs=costs, outcomes=outcomes, true_p=true_p,
                         compute=compute, bandwidth=bandwidth, latency=tau)
