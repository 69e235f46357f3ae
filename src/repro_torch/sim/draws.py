"""The counter-based draw schedule of the simulator.

Every random quantity the simulator consumes is drawn from a threefry key
addressed by ``(seed, t, tag)`` (``SCHEDULE_ID``); draws are unit-scale
(U[0,1), standard normal, Exp(1)) and each consumer applies its own
scaling. The tags are frozen with the reference's numbering, so the
port's streams are the reference's streams (``repro_torch.random``).

Seeds may be an int or an int tensor ``(S,)``: every draw then carries a
leading seed axis. Because the schedule is counter-based, a draw that is
not made shifts no other stream.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as jr

SCHEDULE_ID = "threefry2x32/(seed,t,tag)/v1"

# fold_in tags — frozen; append, never renumber
_INIT, _ROUND = 0, 1
_POS, _PRICE, _BW0, _COMP0, _PERM, _PHASE = 0, 1, 2, 3, 4, 5
_MOVE, _BWJ, _COMPJ, _FDT, _FUT, _MCDT, _MCUT = 0, 1, 2, 3, 4, 5, 6


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
