"""Declarative evaluation suites: named (scenario x policy x config)
cell sets over ``ExperimentSpec`` (a copy of the reference's
``trials/suite.py``).

A :class:`TrialSuite` is data, not code: a frozen, JSON-round-trippable
description of which policies to evaluate (display name + ``PolicySpec``,
so the per-policy seed offsets are explicit), over which config axes
(any ``repro_torch.api.GRID_AXES`` name: scenario, budget, deadline,
h_t, alpha, ...), against which oracle reference, starting from one base
spec. ``cells()`` materializes the cross product; the runner
(``trials.runner``) batches the batchable axes through the grid path
and scores every cell against the same-draw-schedule oracle cell
(``trials.metrics``). ``to_json`` writes the reference's string for the
same suite, so a suite file written by either package loads in the
other.

Named suites register in :data:`SUITES` (``trials.suites`` holds the
shipped ``paper-fig3``, ``paper-fig4-quick`` and ``robustness-panel``)
and run by name: ``repro_torch.trials.run_suite("paper-fig3")``.
"""
from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Mapping, NamedTuple, Tuple, Union

from repro_torch.api.spec import (GRID_AXES, EvalSpec, ExperimentSpec,
                                  PolicySpec)


class TrialCell(NamedTuple):
    """One (policy, config-coordinate) evaluation cell of a suite."""
    policy: str                              # display name
    coord: Tuple[Tuple[str, Any], ...]       # ((axis, value), ...) in
    spec: ExperimentSpec                     # suite-axes order

    @property
    def cell_id(self) -> str:
        """Stable ledger id: ``COCS`` / ``COCS_budget_3.5``."""
        parts = [self.policy] + [f"{a}_{v}" for a, v in self.coord]
        return "_".join(parts)


# base-spec fields a smoke variant may override, and how they apply
_SMOKE_FIELDS: Dict[str, Callable[[ExperimentSpec, Any], ExperimentSpec]] = {
    "horizon": lambda s, v: replace(s, horizon=int(v)),
    "seeds": lambda s, v: replace(s, seeds=tuple(int(x) for x in v)),
    "eval_every": lambda s, v: replace(s, eval=EvalSpec(int(v))),
}


@dataclass(frozen=True)
class TrialSuite:
    """A named, serializable set of (policy x config) evaluation cells."""
    name: str
    base: ExperimentSpec
    policies: Tuple[Tuple[str, PolicySpec], ...]
    axes: Tuple[Tuple[str, Tuple[Any, ...]], ...] = ()
    oracle: str = "Oracle"                   # regret reference row
    smoke: Tuple[Tuple[str, Any], ...] = ()  # tiny-horizon CI variant
    description: str = ""

    def __post_init__(self):
        if not self.policies:
            raise ValueError("a suite needs at least one policy")
        names = [n for n, _ in self.policies]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate policy display names: {names}")
        for axis, values in self.axes:
            if axis == "policy":
                raise ValueError("the policy axis is the suite's "
                                 "'policies' field, not a config axis")
            if axis not in GRID_AXES:
                raise KeyError(f"unknown config axis {axis!r}; available: "
                               f"{tuple(sorted(GRID_AXES))}")
            if not values:
                raise ValueError(f"axis {axis!r} has no values")
        for field, _ in self.smoke:
            if field not in _SMOKE_FIELDS:
                raise KeyError(f"unknown smoke override {field!r}; "
                               f"available: {tuple(sorted(_SMOKE_FIELDS))}")

    # -- cell expansion ------------------------------------------------------

    def label(self, smoke: bool = False) -> str:
        """Ledger label of one run variant (``name`` / ``name@smoke``):
        variants gate against their own baselines."""
        return f"{self.name}@smoke" if smoke else self.name

    def resolved_base(self, smoke: bool = False) -> ExperimentSpec:
        spec = self.base
        if smoke:
            if not self.smoke:
                raise ValueError(f"suite {self.name!r} declares no smoke "
                                 "overrides")
            for field, value in self.smoke:
                spec = _SMOKE_FIELDS[field](spec, value)
        return spec

    def coords(self) -> Tuple[Tuple[Tuple[str, Any], ...], ...]:
        """Config-axis coordinates in C order (last axis fastest); a
        single empty coordinate when the suite has no axes."""
        names = [a for a, _ in self.axes]
        return tuple(tuple(zip(names, combo)) for combo in
                     itertools.product(*(v for _, v in self.axes)))

    def cells(self, smoke: bool = False) -> Tuple[TrialCell, ...]:
        base = self.resolved_base(smoke)
        out = []
        for display, pspec in self.policies:
            spec0 = replace(base, policy=pspec)
            for coord in self.coords():
                spec = spec0
                for axis, value in coord:
                    spec = GRID_AXES[axis][1](spec, value)
                out.append(TrialCell(display, coord, spec))
        return tuple(out)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "base": self.base.to_dict(),
                "policies": [[n, p.to_dict()] for n, p in self.policies],
                "axes": [[a, list(v)] for a, v in self.axes],
                "oracle": self.oracle, "smoke": dict(self.smoke),
                "description": self.description}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TrialSuite":
        return cls(
            name=str(d["name"]),
            base=ExperimentSpec.from_dict(d["base"]),
            policies=tuple((str(n), PolicySpec.from_dict(p))
                           for n, p in d["policies"]),
            axes=tuple((str(a), tuple(v)) for a, v in d.get("axes", [])),
            oracle=str(d.get("oracle", "Oracle")),
            smoke=tuple((str(k), tuple(v) if isinstance(v, (list, tuple))
                         else v)
                        for k, v in dict(d.get("smoke", {})).items()),
            description=str(d.get("description", "")))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "TrialSuite":
        return cls.from_dict(json.loads(s))


# -- named-suite registry ----------------------------------------------------

SUITES: Dict[str, TrialSuite] = {}


def register_suite(suite: TrialSuite) -> TrialSuite:
    SUITES[suite.name] = suite
    return suite


def available() -> Tuple[str, ...]:
    return tuple(sorted(SUITES))


def get_suite(name_or_suite: Union[str, TrialSuite]) -> TrialSuite:
    if isinstance(name_or_suite, TrialSuite):
        return name_or_suite
    key = str(name_or_suite)
    if key not in SUITES:
        raise KeyError(f"unknown trial suite {key!r}; available: "
                       f"{available()}")
    return SUITES[key]


__all__ = ["SUITES", "TrialCell", "TrialSuite", "available", "get_suite",
           "register_suite"]
