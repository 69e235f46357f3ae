"""The counter-based draw schedule of the simulator.

Every random quantity the simulator consumes is drawn from a threefry key
addressed by ``(seed, t, tag)`` (``SCHEDULE_ID``); draws are unit-scale
(U[0,1), standard normal, Exp(1)) and each consumer applies its own
scaling. The tags are frozen with the reference's numbering, so the
port's streams are the reference's streams (``repro_torch.random``).

Seeds may be an int or an int tensor ``(S,)``: every draw then carries a
leading seed axis. Because the schedule is counter-based, a draw that is
not made shifts no other stream.

The fault streams (tags 7-11, ``fault_draws``) are drawn only when a
``FaultSpec`` enables their process.

``shard_round_draws``/``shard_fault_draws`` give a client shard's rows
of the dense draws bit for bit, computing only those rows (the sharded
cohort engine, ``repro_torch.mesh``): counter i of a draw is its flat
index, so a row slice is a slice of counters.

The host simulator (``core.network.HFLNetworkSim``, float64 numpy) takes
``host_init_draws`` / ``host_round_draws`` / ``host_fault_draws``:
float64 numpy views of the same float32 draws, made on the CPU. ``host_round_draws`` realizes a
block of consecutive rounds in one call (a tensor of rounds) and caches
it, as the reference's block cache does: one round at a time, the
dispatch of the threefry ops would dominate the host env.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as jr

SCHEDULE_ID = "threefry2x32/(seed,t,tag)/v1"

# fold_in tags — frozen; append, never renumber
_INIT, _ROUND = 0, 1
_POS, _PRICE, _BW0, _COMP0, _PERM, _PHASE = 0, 1, 2, 3, 4, 5
_MOVE, _BWJ, _COMPJ, _FDT, _FUT, _MCDT, _MCUT = 0, 1, 2, 3, 4, 5, 6
# fault-injection streams (sim.faults), appended: with faults off they
# are never drawn, and no other stream moves
_FDROP, _FSTRAG_U, _FSTRAG_E, _FOUT, _FCORR = 7, 8, 9, 10, 11


class InitDraws(NamedTuple):
    """Experiment-lifetime draws (all unit-scale)."""
    pos_u: torch.Tensor      # (..., N, 2) U[0,1) — initial positions
    price_u: torch.Tensor    # (..., N)  U[0,1) — price or tier selector
    bw_u: torch.Tensor       # (..., N)  U[0,1) — base bandwidth profile
    comp_u: torch.Tensor     # (..., N)  U[0,1) — base compute profile
    perm: torch.Tensor       # (..., N)  int32 permutation — surge cohort
    phase_u: torch.Tensor    # (..., N)  U[0,1) — bursty-arrival phase


class RoundDraws(NamedTuple):
    """Per-round draws (all unit-scale)."""
    move: torch.Tensor       # (..., N, 2) std normal — mobility step
    bw_n: torch.Tensor       # (..., N)  std normal — bandwidth jitter
    comp_n: torch.Tensor     # (..., N)  std normal — compute jitter
    fad_dt: torch.Tensor     # (..., N, M) Exp(1) — downlink |h|^2
    fad_ut: torch.Tensor     # (..., N, M) Exp(1) — uplink |h|^2
    mc_dt: torch.Tensor      # (..., K, N, M) Exp(1) — true_p MC, downlink
    mc_ut: torch.Tensor      # (..., K, N, M) Exp(1) — true_p MC, uplink


class FaultDraws(NamedTuple):
    """Per-round fault-event draws (all unit-scale). Events threshold
    ``float32(u) < float32(rate)`` on both envs (``sim.faults``), so
    they are the same events on the float64 host env and on the device
    env. A field that was not asked for is None."""
    drop_u: Optional[torch.Tensor]     # (..., N) U[0,1) — client dropout
    strag_u: Optional[torch.Tensor]    # (..., N) U[0,1) — straggler events
    strag_e: Optional[torch.Tensor]    # (..., N) Exp(1) — inflation
    out_u: Optional[torch.Tensor]      # (..., M) U[0,1) — ES outages
    corr_u: Optional[torch.Tensor]     # (..., N) U[0,1) — corrupted updates


def init_key(seed, device=None) -> torch.Tensor:
    return jr.fold_in(jr.PRNGKey(seed, device), _INIT)


def round_key(seed, t, device=None) -> torch.Tensor:
    return jr.fold_in(jr.fold_in(jr.PRNGKey(seed, device), _ROUND), t)


def init_draws(seed, n: int, device=None) -> InitDraws:
    k = init_key(seed, device)
    return InitDraws(
        pos_u=jr.uniform(jr.fold_in(k, _POS), (n, 2)),
        price_u=jr.uniform(jr.fold_in(k, _PRICE), (n,)),
        bw_u=jr.uniform(jr.fold_in(k, _BW0), (n,)),
        comp_u=jr.uniform(jr.fold_in(k, _COMP0), (n,)),
        perm=jr.permutation(jr.fold_in(k, _PERM), n),
        phase_u=jr.uniform(jr.fold_in(k, _PHASE), (n,)),
    )


def round_draws(seed, t, n: int, m: int, k_mc: int,
                device=None) -> RoundDraws:
    """The round's draws. ``k_mc = 0`` (analytic ``true_p``) makes no
    Monte-Carlo draw at all: its two fields are empty tensors, and the
    threefry ops of a draw of size 0 are not dispatched."""
    k = round_key(seed, t, device)
    sub = lambda tag: jr.fold_in(k, tag)
    if k_mc > 0:
        mc = lambda tag: jr.exponential(sub(tag), (k_mc, n, m))
    else:
        mc = lambda tag: torch.empty(k.shape[:-1] + (0, n, m),
                                     dtype=torch.float32, device=k.device)
    return RoundDraws(
        move=jr.normal(sub(_MOVE), (n, 2)),
        bw_n=jr.normal(sub(_BWJ), (n,)),
        comp_n=jr.normal(sub(_COMPJ), (n,)),
        fad_dt=jr.exponential(sub(_FDT), (n, m)),
        fad_ut=jr.exponential(sub(_FUT), (n, m)),
        mc_dt=mc(_MCDT),
        mc_ut=mc(_MCUT),
    )


def _rows(lead: int, n: int, width: int, lo: int, n_local: int,
          device) -> torch.Tensor:
    """Flat indices of rows ``lo .. lo+n_local`` of a ``(lead, n,
    width)`` draw, as a ``(lead, n_local, width)`` int64 tensor."""
    r = torch.arange(lo, lo + n_local, dtype=torch.int64, device=device)
    c = torch.arange(width, dtype=torch.int64, device=device)
    k = torch.arange(lead, dtype=torch.int64, device=device)
    return (k[:, None, None] * n + r[None, :, None]) * width + c


def shard_round_draws(seed, t, n: int, m: int, k_mc: int, lo: int,
                      n_local: int, device=None) -> RoundDraws:
    """Rows ``lo .. lo+n_local`` of ``round_draws(seed, t, n, m, k_mc)``
    bit for bit (the ``mc_*`` fields sliced along their client axis),
    computing only those rows' words: counter i of a draw is its flat
    index, so no dense ``(N, ...)`` tensor is made."""
    k = round_key(seed, t, device)
    dev = k.device
    sub = lambda tag: jr.fold_in(k, tag)
    at = lambda w, lead=1: _rows(lead, n, w, lo, n_local, dev)
    one = lambda w: at(w)[0] if w > 1 else at(1)[0, :, 0]
    if k_mc > 0:
        mc = lambda tag: jr.exponential(sub(tag), None, at(m, k_mc))
    else:
        mc = lambda tag: torch.empty(k.shape[:-1] + (0, n_local, m),
                                     dtype=torch.float32, device=dev)
    return RoundDraws(
        move=jr.normal(sub(_MOVE), None, one(2)),
        bw_n=jr.normal(sub(_BWJ), None, one(1)),
        comp_n=jr.normal(sub(_COMPJ), None, one(1)),
        fad_dt=jr.exponential(sub(_FDT), None, one(m)),
        fad_ut=jr.exponential(sub(_FUT), None, one(m)),
        mc_dt=mc(_MCDT),
        mc_ut=mc(_MCUT),
    )


_FAULT_TAGS = {"drop_u": (_FDROP, False), "strag_u": (_FSTRAG_U, False),
               "strag_e": (_FSTRAG_E, False), "out_u": (_FOUT, True),
               "corr_u": (_FCORR, False)}


def fault_draws(seed, t, n: int, m: int, device=None,
                fields: Sequence[str] = FaultDraws._fields) -> FaultDraws:
    """The round's fault draws, the reference's ``fault_draws``. Only
    the streams named in ``fields`` are drawn (the rest are None): each
    has its own tag, so what is drawn does not depend on what else is
    (the reference's unused streams are dead code under ``jit``)."""
    k = round_key(seed, t, device)
    out = {}
    for f in fields:
        tag, per_es = _FAULT_TAGS[f]
        draw = jr.exponential if f == "strag_e" else jr.uniform
        out[f] = draw(jr.fold_in(k, tag), (m if per_es else n,))
    return FaultDraws(**{f: out.get(f) for f in FaultDraws._fields})


def shard_fault_draws(seed, t, n: int, m: int, lo: int, n_local: int,
                      device=None,
                      fields: Sequence[str] = FaultDraws._fields
                      ) -> FaultDraws:
    """Rows ``lo .. lo+n_local`` of ``fault_draws`` bit for bit: the
    per-client streams sliced, the per-ES ``out_u`` whole (M,)."""
    k = round_key(seed, t, device)
    rows = torch.arange(lo, lo + n_local, dtype=torch.int64,
                        device=k.device)
    out = {}
    for f in fields:
        tag, per_es = _FAULT_TAGS[f]
        draw = jr.exponential if f == "strag_e" else jr.uniform
        key = jr.fold_in(k, tag)
        out[f] = draw(key, (m,)) if per_es else draw(key, None, at=rows)
    return FaultDraws(**{f: out.get(f) for f in FaultDraws._fields})


# -- host access: float64 numpy views, made on the CPU ----------------------

def _to_host(draws: NamedTuple):
    """float32 tensors -> float64 numpy arrays; integer draws keep their
    dtype."""
    return type(draws)(*(a.numpy().astype(np.float64)
                         if a.dtype == torch.float32 else a.numpy()
                         for a in draws))


def host_init_draws(seed: int, n: int) -> InitDraws:
    """Float64 numpy view of the float32 init draws for ``seed``."""
    return _to_host(init_draws(int(seed), n))


def host_fault_draws(seed: int, t: int, n: int, m: int,
                     fields: Sequence[str] = FaultDraws._fields
                     ) -> FaultDraws:
    """Float64 numpy view of the float32 round-``t`` fault draws (one
    (N,) or (M,) vector a stream, so no block cache)."""
    fd = fault_draws(int(seed), int(t), n, m, fields=fields)
    return FaultDraws(*(None if a is None else a.numpy().astype(np.float64)
                        for a in fd))


# block-aligned cache of realized round draws, kept as float32 (the MC
# fading tensors dominate; the upcast happens per round on access). A
# bounded FIFO: sequential consumers touch each block once per seed.
_BLOCK_TARGET = 2_000_000      # ~floats per cached block
_block_cache: dict = {}
_BLOCK_CACHE_MAX = 8


def _block_size(n: int, m: int, k_mc: int) -> int:
    return max(1, min(32, _BLOCK_TARGET // max(1, k_mc * n * m)))


def host_round_draws(seed: int, t: int, n: int, m: int,
                     k_mc: int) -> RoundDraws:
    """Float64 numpy view of the float32 round-``t`` draws for ``seed``.

    The draws of a block of consecutive rounds are realized in one call
    (a tensor of rounds gives every draw a leading round axis) and
    cached, so a sequential ``round(t)`` consumer pays the threefry cost
    in bulk."""
    block = _block_size(n, m, k_mc)
    bi, off = divmod(int(t), block)
    key = (int(seed), n, m, k_mc, bi)
    blk = _block_cache.get(key)
    if blk is None:
        ts = torch.arange(bi * block, (bi + 1) * block, dtype=torch.int64)
        blk = RoundDraws(*(a.numpy() for a in round_draws(
            int(seed), ts, n, m, k_mc)))
        while len(_block_cache) >= _BLOCK_CACHE_MAX:
            _block_cache.pop(next(iter(_block_cache)))
        _block_cache[key] = blk
    return RoundDraws(*(a[off].astype(np.float64) for a in blk))
