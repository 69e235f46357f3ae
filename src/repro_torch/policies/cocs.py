"""COCS: the paper's CC-MAB policy (index mode) on tensors.

State is two tensors, per-(seed, client, ES, hypercube) visit counters
and participation estimates. A round bins each eligible pair's context
into its hypercube, values under-explored pairs optimistically (UCB
bonus; the Theorem 2 threshold ``K(t) = t^z log t``), solves P2 with the
density greedy (``solvers.greedy_assign``), or P3 with FLGreedy under
the sqrt utility (``solvers.flgreedy_assign``), and folds the observed
outcomes of the selected pairs into the estimates. The arithmetic is the
reference's (``policies/cocs.py``), operation for operation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.cocs import theorem2_params
from repro_torch.core.fmath import sqrt_rn
from repro_torch.policies.base import FunctionalPolicy, Round
from repro_torch.policies.solvers import flgreedy_assign, greedy_assign


# the reference's defaults: K(t) multiplier and UCB bonus coefficient
K_SCALE = 1.0
BONUS_SCALE = 0.35


class COCSState(NamedTuple):
    counters: torch.Tensor     # (S, N, M, h, h) int32
    p_hat: torch.Tensor        # (S, N, M, h, h) float32


HParam = Union[int, torch.Tensor]
ZParam = Union[float, torch.Tensor]


@dataclass(frozen=True)
class COCS(FunctionalPolicy):
    """Index-mode COCS: P2's density greedy, or P3's FLGreedy when the
    spec has the sqrt utility."""
    alpha: float = 1.0
    h_t: Optional[int] = None

    name: str = field(default="COCS")
    tensor_capable: ClassVar[bool] = True

    def _params(self) -> Tuple[float, int]:
        z, h_thm = theorem2_params(self.spec.horizon, self.alpha)
        return z, (self.h_t if self.h_t is not None else h_thm)

    # ``h`` (the hypercube resolution) and ``z`` (Theorem 2's exponent)
    # enter select and update as data: Python numbers for one
    # configuration, or (S,) tensors, one value a batch element, over a
    # state padded to a shared ``h_pad`` lattice (the grid engines' h_t
    # and alpha axes). The lattice stride is always the state's ``h_pad``
    # and cube indices stop at each element's own ``h - 1``, so padded
    # cells stay zero and each element equals its unpadded run bitwise.

    def init(self, num_seeds: int, device=None, seeds=None) -> COCSState:
        _, h = self._params()
        return self.init_padded(num_seeds, h, device)

    def init_padded(self, num_seeds: int, h_pad: int, device=None
                    ) -> COCSState:
        """Zero state over an (S, N, M, h_pad, h_pad) lattice."""
        shape = (num_seeds, self.spec.num_clients,
                 self.spec.num_edge_servers, h_pad, h_pad)
        return COCSState(
            counters=torch.zeros(shape, dtype=torch.int32, device=device),
            p_hat=torch.zeros(shape, dtype=torch.float32, device=device))

    def _cubes(self, contexts: torch.Tensor, h: HParam) -> torch.Tensor:
        if isinstance(h, torch.Tensor):          # one h a batch element
            h = h.view(-1, 1, 1, 1)
            idx = torch.floor(torch.nan_to_num(contexts) * h).to(torch.int32)
            return torch.minimum(torch.clamp(idx, min=0), h - 1)
        idx = torch.floor(torch.nan_to_num(contexts) * h).to(torch.int32)
        return torch.clamp(idx, 0, h - 1)

    @staticmethod
    def _cell(cubes: torch.Tensor, j: torch.Tensor, h_pad: int, m: int
              ) -> torch.Tensor:
        """Flat (client, ES, cube) cell index into (S, N*M*h_pad*h_pad)."""
        n = cubes.shape[1]
        i = torch.arange(n, device=cubes.device).view(1, n,
                                                      *([1] * (j.dim() - 2)))
        c0, c1 = cubes[..., 0].long(), cubes[..., 1].long()
        return ((i * m + j) * h_pad + c0) * h_pad + c1

    def _gather(self, arr: torch.Tensor, cubes: torch.Tensor
                ) -> torch.Tensor:
        s, n, m = cubes.shape[:3]
        j = torch.arange(m, device=cubes.device).view(1, 1, m)
        cell = self._cell(cubes, j, arr.shape[-1], m)
        return torch.gather(arr.reshape(s, -1), 1,
                            cell.reshape(s, -1)).reshape(s, n, m)

    def k_of_t(self, t: torch.Tensor, z: ZParam) -> torch.Tensor:
        tf = torch.clamp(t.to(torch.float32), min=1.0)
        return K_SCALE * tf ** z * torch.log(torch.clamp(tf, min=2.0))

    def pair_values(self, state: COCSState, rd: Round, h: HParam = None,
                    z: ZParam = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The optimistic score table the greedy solver gets, as
        ``(values, under)`` (both (S, N, M))."""
        if h is None or z is None:
            z, h = self._params()
        cubes, counts, under, bonus = self._confidence(state, rd, h, z)
        est = self._gather(state.p_hat, cubes)
        optimistic = torch.where(counts == 0, torch.ones_like(est),
                                 torch.clamp(est + bonus, max=1.0))
        return torch.where(under, optimistic, est), under

    def _confidence(self, state: COCSState, rd: Round, h: HParam,
                    z: ZParam):
        """Each pair's cube, visit count, under-explored flag and UCB
        bonus ``0.35 * sqrt(2 log t / count)`` (all (S, N, M))."""
        cubes = self._cubes(rd.contexts, h)
        counts = self._gather(state.counters, cubes)
        t1 = rd.t.to(torch.int32) + 1
        under = rd.eligible & (counts <= self.k_of_t(t1, z)[:, None, None])
        tf = torch.clamp(t1.to(torch.float32), min=2.0)
        bonus = BONUS_SCALE * sqrt_rn(
            (2.0 * torch.log(tf))[:, None, None]
            / torch.clamp(counts, min=1))
        return cubes, counts, under, bonus

    def telemetry_sums(self, state: COCSState, rd: Round) -> dict:
        """The sums behind ``telemetry_tap``, per batch element: the UCB
        width over the eligible pairs, their count, and the count of
        under-explored ones."""
        z, h = self._params()
        _, counts, under, bonus = self._confidence(state, rd, h, z)
        width = torch.where(counts == 0, torch.ones_like(bonus),
                            torch.clamp(bonus, max=1.0))
        eligible = rd.eligible
        return {"width_sum": torch.where(eligible, width,
                                         torch.zeros_like(width))
                .sum(dim=(1, 2)),
                "eligible": eligible.sum(dim=(1, 2)),
                "under": under.sum(dim=(1, 2))}

    def telemetry_tap(self, state: COCSState, rd: Round) -> dict:
        """The CC-MAB confidence profile at select time
        (``obs.telemetry``): the eligible pairs' mean UCB width, the
        select's ``0.35 * sqrt(2 log t / count)`` capped at 1 and 1 for
        an unvisited cube, and the count of under-explored eligible pairs
        (Theorem 2's ``K(t)``). Gathers on the state: no draw, no state
        change."""
        sums = self.telemetry_sums(state, rd)
        n_el = torch.clamp(sums["eligible"], min=1)
        return {"ucb_width": sums["width_sum"] / n_el,
                "underexplored": sums["under"].to(torch.float32)}

    def select_with_budgets(self, state: COCSState, rd: Round,
                            budgets: torch.Tensor):
        z, h = self._params()
        return self.select_with_params(state, rd, budgets, h, z)

    def select_with_params(self, state: COCSState, rd: Round,
                           budgets: torch.Tensor, h: HParam, z: ZParam):
        """``select_with_budgets`` with ``h`` and ``z`` given: numbers, or
        (S,) int32 and float32 tensors over an ``init_padded`` state."""
        values, under = self.pair_values(state, rd, h, z)
        solve = flgreedy_assign if self.spec.sqrt_utility else greedy_assign
        assign = solve(values, rd.costs.to(values.dtype), budgets,
                       rd.eligible)
        return assign, {"explored": under.any(dim=2).any(dim=1)}

    def update(self, state: COCSState, rd: Round, assign: torch.Tensor,
               aux=None) -> COCSState:
        _, h = self._params()
        return self.update_with_params(state, rd, assign, h)

    def update_with_params(self, state: COCSState, rd: Round,
                           assign: torch.Tensor, h: HParam) -> COCSState:
        counters, p_hat = state
        s, n, m, h_pad = counters.shape[:4]
        cubes = self._cubes(rd.contexts, h)
        assign = assign.long()
        sel = assign >= 0
        j = torch.clamp(assign, 0, m - 1)
        ab = torch.gather(cubes, 2, j[:, :, None, None].expand(s, n, 1, 2)
                          )[:, :, 0]                       # (S, N, 2)
        i = torch.arange(n, device=j.device)[None]
        cell = (((i * m + j) * h_pad + ab[..., 0].long()) * h_pad
                + ab[..., 1].long())
        x = torch.gather(rd.outcomes.to(p_hat.dtype), 2,
                         j[..., None])[..., 0]
        cflat, pflat = counters.reshape(s, -1), p_hat.reshape(s, -1)
        c_old = torch.gather(cflat, 1, cell)
        p_old = torch.gather(pflat, 1, cell)
        p_new = (p_old * c_old + x) / (c_old + 1)
        # one cell per (seed, client): the scatters never collide
        pflat = pflat.scatter(1, cell, torch.where(sel, p_new, p_old))
        cflat = cflat.scatter(1, cell, torch.where(sel, c_old + 1, c_old))
        return COCSState(counters=cflat.view_as(counters),
                         p_hat=pflat.view_as(p_hat))
