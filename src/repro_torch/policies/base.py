"""Functional policy API: a frozen config dataclass with pure
``init``/``select``/``update`` on tensors.

    state          = policy.init(num_seeds, device, seeds)
    assign, aux    = policy.select(state, rd)
    state          = policy.update(state, rd, assign, aux)

Every tensor carries a leading seed axis ``S``: one call selects for
all seeds at once (the reference ``vmap``s the same functions).
``select_with_budgets`` takes the per-ES budgets as an (S, M) tensor,
one row per batch element: the grid engines batch budget cells next to
the seeds that way (``policies.engine``).

The host env's ``RoundData`` (float64 numpy) becomes a ``Round`` through
``round_from_data`` (numpy in the reference's float32 dtypes) and
``round_from_arrays`` (tensors). Host-state policies (CUCB, LinUCB,
phased COCS, ``tensor_capable = False``) select on ``RoundData`` one seed
at a time; ``PolicyAdapter`` drives them one round at a time, and a
tensor policy too, one seed on a given device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, ClassVar, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.paper_hfl import HFLExperimentConfig


class Round(NamedTuple):
    """One round's observables (tensors with a leading seed axis)."""
    t: Any            # (S,) int32 round index
    contexts: Any     # (S, N, M, 2)
    eligible: Any     # (S, N, M) bool
    costs: Any        # (S, N)
    outcomes: Any     # (S, N, M)
    true_p: Any       # (S, N, M)
    latency: Any      # (S, N, M) realized tau


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device=device, dtype=dtype)


_ROUND_DTYPES = (torch.int32, torch.float32, torch.bool, torch.float32,
                 torch.float32, torch.float32, torch.float32)


def round_from_arrays(fields: Sequence[Any], device=None) -> Round:
    """A ``Round`` of tensors from any stacked batch of arrays in the
    reference's field order (``t, contexts, eligible, costs, outcomes,
    true_p, latency``), with leading axes such as (T, ...) or (S, T, ...):
    numpy arrays, the reference's ``Round`` or the port's own."""
    fields = tuple(fields)
    if len(fields) != len(Round._fields):
        raise ValueError(f"a round has {len(Round._fields)} fields "
                         f"{Round._fields}, got {len(fields)}")
    return Round(*(_tensor(f, dt, device)
                   for f, dt in zip(fields, _ROUND_DTYPES)))


def round_from_data(rd) -> Round:
    """One host ``RoundData`` -> a ``Round`` of numpy arrays in the
    float32 dtypes the tensor policies take (contexts' NaNs zeroed)."""
    lat = rd.latency if rd.latency is not None else 1.0 - rd.true_p
    return Round(t=np.int32(rd.t),
                 contexts=np.nan_to_num(rd.contexts).astype(np.float32),
                 eligible=np.asarray(rd.eligible, bool),
                 costs=rd.costs.astype(np.float32),
                 outcomes=rd.outcomes.astype(np.float32),
                 true_p=rd.true_p.astype(np.float32),
                 latency=np.asarray(lat, np.float32))


def stack_rounds(rounds) -> Round:
    """List of RoundData -> ``Round`` of numpy arrays with a leading T
    axis."""
    views = [round_from_data(rd) for rd in rounds]
    return Round(*(np.stack([getattr(v, f) for v in views])
                   for f in Round._fields))


def rounds_to_scan_axes(batch: Round) -> Round:
    """(S, T, ...) multi-seed batch -> (T, S, ...), so a block walks
    rounds with the seed axis batched inside each step."""
    return Round(*(np.moveaxis(np.asarray(getattr(batch, f)), 1, 0)
                   for f in Round._fields))


@dataclass(frozen=True)
class PolicySpec:
    """Problem dimensions shared by every policy."""
    num_clients: int
    num_edge_servers: int
    budget: float
    horizon: int
    sqrt_utility: bool = False

    @classmethod
    def from_experiment(cls, cfg: HFLExperimentConfig, horizon: int,
                        budget: Optional[float] = None) -> "PolicySpec":
        return cls(num_clients=cfg.num_clients,
                   num_edge_servers=cfg.num_edge_servers,
                   budget=float(cfg.budget if budget is None else budget),
                   horizon=horizon,
                   sqrt_utility=cfg.utility == "sqrt")

    def budgets(self) -> np.ndarray:
        return np.full(self.num_edge_servers, self.budget, np.float32)

    def budgets_like(self, costs: torch.Tensor) -> torch.Tensor:
        """The spec's budgets as an (S, M) tensor beside ``costs`` (S, N)."""
        return torch.as_tensor(self.budgets(), device=costs.device).expand(
            costs.shape[0], self.num_edge_servers)


@dataclass(frozen=True)
class FunctionalPolicy:
    """Base for policies: frozen, hashable, pure functions of tensors.
    ``tensor_capable`` marks the policies whose select and update are
    tensor functions that the engines can drive (all of the port's)."""
    spec: PolicySpec

    name: str = "base"
    tensor_capable: ClassVar[bool] = False

    def init(self, num_seeds: int, device=None, seeds=None):
        """The state for ``num_seeds`` seeds; a policy that draws keys
        takes them from ``seeds`` (default ``0 .. num_seeds - 1``)."""
        raise NotImplementedError

    def select(self, state, rd: Round) -> Tuple[Any, Any]:
        return self.select_with_budgets(
            state, rd, self.spec.budgets_like(rd.costs))

    def select_with_budgets(self, state, rd: Round, budgets: torch.Tensor
                            ) -> Tuple[Any, Any]:
        """``select`` under per-element budgets (S, M) float32."""
        raise NotImplementedError(
            f"{self.name} does not take per-call budgets")

    def update(self, state, rd: Round, assign, aux=None):
        return state

    def telemetry_tap(self, state, rd: Round) -> dict:
        """Observability read of the state at select time
        (``obs.telemetry``): (S,) metrics such as ``ucb_width`` and
        ``underexplored``, derived without a draw or a state change. The
        base policy reports none."""
        del state, rd
        return {}


class PolicyAdapter:
    """One seed of a policy, one round at a time, on ``RoundData``:
    ``select(rd) -> assign`` (N,) int64, ``update(rd, assign)``, ``step``
    (both), ``name`` and ``last_explored``, the reference's legacy
    interface (``policies.make_legacy`` builds one).

    A host-state policy selects on the ``RoundData`` itself. A tensor
    policy runs on ``device``, which it must be given: each round becomes
    a one-seed ``Round`` on that device through ``round_from_data``, and
    its state stays there (``seed`` picks its keys). Only the assignment
    comes back to the host; ``last_explored`` is read when asked for."""

    def __init__(self, policy: FunctionalPolicy, seed: int = 0,
                 device=None):
        if policy.tensor_capable and device is None:
            raise ValueError(
                f"{policy.name} is a tensor policy; PolicyAdapter drives it "
                "one seed at a time on a given device= (run_rounds drives "
                "tensor policies over seeds)")
        self.policy = policy
        self.name = policy.name
        self.device = None if device is None else torch.device(device)
        if policy.tensor_capable:
            self._state = policy.init(1, self.device, seeds=(int(seed),))
        else:
            self._state = policy.init(int(seed))
        self._aux = None
        self._round = None          # (RoundData, its Round) of the select
        self._explored = False

    @property
    def last_explored(self) -> bool:
        return bool(np.asarray(
            self._explored.cpu() if isinstance(self._explored, torch.Tensor)
            else self._explored).reshape(-1)[0])

    def _as_round(self, rd) -> Round:
        if self._round is None or self._round[0] is not rd:
            view = round_from_data(rd)
            self._round = (rd, round_from_arrays(
                [np.asarray(f)[None] for f in view], self.device))
        return self._round[1]

    def select(self, rd) -> np.ndarray:
        if self.policy.tensor_capable:
            assign, aux = self.policy.select(self._state, self._as_round(rd))
            assign = assign[0].cpu()
        else:
            assign, aux = self.policy.select(self._state, rd)
        self._aux = aux
        if "explored" in aux:
            self._explored = aux["explored"]
        return np.asarray(assign, np.int64)

    def update(self, rd, assign: np.ndarray) -> None:
        if self.policy.tensor_capable:
            a = torch.as_tensor(np.asarray(assign, np.int32)[None],
                                device=self.device)
            self._state = self.policy.update(self._state,
                                             self._as_round(rd), a,
                                             self._aux)
        else:
            self._state = self.policy.update(self._state, rd,
                                             np.asarray(assign), self._aux)

    def step(self, rd) -> np.ndarray:
        assign = self.select(rd)
        self.update(rd, assign)
        return assign

    @property
    def state(self):
        return self._state
