"""Declarative experiment descriptions: one frozen, JSON-round-trippable
``ExperimentSpec`` for every execution tier (a copy of the reference's
``api/spec.py``).

An ``ExperimentSpec`` bundles *what* to run (selection policy, network
environment, optional training, evaluation cadence, seeds) without
saying *how*; ``repro_torch.run`` picks the engine. Everything is a
frozen dataclass of plain values (strings, numbers, tuples), so a spec
is hashable and round-trips losslessly through ``to_dict``/``from_dict``
and JSON. ``to_json`` writes the reference's string for the same spec,
so one spec JSON drives either package.

``spec.grid(budget=[...], deadline=[...], policy=[...])`` expands a spec
into a config grid (``ExperimentGrid``). Axis values are applied with
``replace`` on the relevant sub-spec; the last-named axis varies fastest
in the expansion (C order over the kwargs). ``GRID_AXES`` marks the
axes that preserve every array shape (budget, deadline, ``h_t``,
``alpha``) as batchable: the grid engines stack their cells next to the
seed axis (``repro_torch.run`` of a grid, ``api.grid``).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.obs.spec import ObsSpec
from repro_torch.sim.faults import FaultSpec


def _pairs(kv) -> Tuple[Tuple[str, Any], ...]:
    """Normalize a mapping / iterable of pairs into a hashable tuple."""
    if isinstance(kv, Mapping):
        return tuple((str(k), v) for k, v in kv.items())
    return tuple((str(k), v) for k, v in (kv or ()))


def _spec_dict(obj) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _spec_dict(v)
        elif isinstance(v, tuple):
            if v and all(isinstance(e, tuple) and len(e) == 2
                         and isinstance(e[0], str) for e in v):
                v = dict(v)             # option pairs -> JSON object
            else:
                v = list(v)
        out[f.name] = v
    return out


def _from_dict(cls, d: Mapping[str, Any], nested=()):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown field(s) "
                         f"{sorted(unknown)}; expected {sorted(names)}")
    kw = dict(d)
    for key, sub in nested:
        if kw.get(key) is not None:
            kw[key] = sub.from_dict(kw[key])
    for key in ("options", "overrides"):
        if key in names and key in kw:
            kw[key] = _pairs(kw[key])
    for key in ("seeds",):
        if key in names and key in kw:
            kw[key] = tuple(int(s) for s in kw[key])
    return cls(**kw)


@dataclass(frozen=True)
class PolicySpec:
    """Which selection policy, and the knobs that are *policy-side*.

    ``budget`` overrides the per-ES budget the policy's solver sees
    (``None`` -> the experiment config's ``budget``); the environment's
    cost realization never depends on it, which is what makes ``budget``
    a shape-preserving (batchable) grid axis. ``options`` are extra
    registry-constructor kwargs (e.g. ``{"alpha": 1.0, "h_t": 5}``);
    omitted COCS knobs default from the experiment config
    (``core.utility._policy_kwargs``). ``seed_offset`` shifts the policy
    init seed relative to each env seed (``POLICY_TABLE``'s offsets).
    """
    name: str = "cocs"
    budget: Optional[float] = None
    seed_offset: int = 0
    options: Tuple[Tuple[str, Any], ...] = ()

    def to_dict(self) -> Dict[str, Any]:
        return _spec_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PolicySpec":
        return _from_dict(cls, d)


@dataclass(frozen=True)
class EnvSpec:
    """Which network environment, on which backend.

    ``scenario`` names a preset (the host scenarios, or the device-only
    cohorts of ``sim.spec.PRESETS``); ``backend="auto"`` picks the
    device simulator exactly when the scenario only exists there.
    ``config`` names a registered
    ``HFLExperimentConfig`` (``configs.paper_hfl.CONFIGS``;
    ``None`` -> the scenario's default), ``overrides`` replace individual
    config fields, and ``deadline`` is sugar for overriding
    ``deadline_s`` — kept explicit because it is the paper's Fig. 4 axis
    and batchable in grids. ``true_p`` picks the ground-truth
    participation estimator: ``"mc"`` (Monte-Carlo fading pairs) or
    ``"analytic"`` (exact Eq. 6 integral, ``sim.truep``). ``use_kernel``
    is the reference's kernel routing; the port routes by device (the
    plain versions on the CPU, the hand kernels on CUDA), and on CUDA
    refuses ``False``. ``faults`` is an optional ``sim.faults.FaultSpec``
    (client dropout, straggler inflation, ES outages, update
    corruption), drawn from the shared counter-based schedule, so both
    envs inject the same events (``None``: no fault draws).
    """
    scenario: str = "paper"
    backend: str = "auto"            # "auto" | "host" | "device"
    config: Optional[str] = None
    deadline: Optional[float] = None
    true_p: str = "mc"               # "mc" | "analytic"
    mc_true_p: int = 128
    use_kernel: Optional[bool] = None
    overrides: Tuple[Tuple[str, Any], ...] = ()
    faults: Optional[FaultSpec] = None

    def to_dict(self) -> Dict[str, Any]:
        return _spec_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "EnvSpec":
        return _from_dict(cls, d, nested=(("faults", FaultSpec),))


@dataclass(frozen=True)
class TrainSpec:
    """HFL training in the loop (omit for a bandit-only run).

    ``transposed_gemm`` is the reference's transposed local-SGD layout
    (``model="logreg"`` only; model kind ``logreg-t``, ``wt`` (classes,
    features)). ``aggregator`` picks the Eq. 3 aggregation rule
    (``fed.robust``): ``"mean"`` is the paper's weighted mean;
    ``"trimmed_mean"`` (drop the ``trim_frac`` tails per coordinate),
    ``"median"`` and ``"clipped"`` (each update's L2 norm clipped at the
    cohort's median) are the robust rules against corrupted updates
    (``FaultSpec.corrupt_rate``). ``use_kernel`` is the reference's
    kernel routing, as ``EnvSpec``'s.
    """
    model: str = "logreg"            # "logreg" | "cnn"
    batch_size: int = 32
    batches_per_epoch: int = 2
    transposed_gemm: bool = False
    use_kernel: Optional[bool] = None
    slots_per_es: Optional[int] = None
    aggregator: str = "mean"   # "mean"|"trimmed_mean"|"median"|"clipped"
    trim_frac: float = 0.1

    def to_dict(self) -> Dict[str, Any]:
        return _spec_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TrainSpec":
        return _from_dict(cls, d)

    @property
    def model_kind(self) -> str:
        if self.transposed_gemm:
            if self.model != "logreg":
                raise ValueError("transposed_gemm only applies to the "
                                 "logreg model")
            return "logreg-t"
        return self.model


@dataclass(frozen=True)
class ShardSpec:
    """Cohort-mesh layout of the client-sharded tier-4 engine
    (``repro_torch.mesh``): how many ways to split the client axis and
    the seed axis over the ranks of a ``torch.distributed`` group of
    ``clients * seeds`` ranks. ``clients = seeds = 1`` leaves the spec
    inert.
    """
    clients: int = 1
    seeds: int = 1

    def __post_init__(self):
        if self.clients < 1 or self.seeds < 1:
            raise ValueError("ShardSpec axes must be >= 1, got "
                             f"clients={self.clients} seeds={self.seeds}")

    def to_dict(self) -> Dict[str, Any]:
        return _spec_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ShardSpec":
        # bypass _from_dict's seeds-as-tuple coercion: here ``seeds``
        # is the shard count, not the experiment seed list
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"ShardSpec: unknown field(s) "
                             f"{sorted(unknown)}; expected {sorted(names)}")
        return cls(**{k: int(v) for k, v in d.items()})


@dataclass(frozen=True)
class EvalSpec:
    """Test-set evaluation cadence (one eval per ``eval_every``
    training rounds, plus one after the final round), and the
    resilient-execution knobs of tiers 3 and 4: per-interval checkpoints
    (``checkpoint_dir``, ``resume``) and the carry's health guard
    (``health``: ``"off"``, ``"record"``, ``"halt"``;
    ``experiment.sweep``).
    """
    eval_every: int = 5
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    health: str = "off"              # "off" | "record" | "halt"

    def to_dict(self) -> Dict[str, Any]:
        return _spec_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "EvalSpec":
        return _from_dict(cls, d)


@dataclass(frozen=True)
class ExperimentSpec:
    """One complete, serializable experiment description.

    ``obs`` (``obs.spec.ObsSpec``) declares how the run is observed
    (telemetry taps, span trace, profiler capture); the default
    ``ObsSpec()`` is all off.
    """
    policy: PolicySpec = field(default_factory=PolicySpec)
    env: EnvSpec = field(default_factory=EnvSpec)
    train: Optional[TrainSpec] = None
    eval: EvalSpec = field(default_factory=EvalSpec)
    horizon: int = 200
    seeds: Tuple[int, ...] = (0,)
    shard_seeds: Optional[bool] = None
    shard: Optional[ShardSpec] = None
    obs: ObsSpec = field(default_factory=ObsSpec)

    def __post_init__(self):
        if self.horizon <= 0:
            raise ValueError("horizon must be positive")
        if not self.seeds:
            raise ValueError("seeds must be non-empty")
        if self.env.true_p not in ("mc", "analytic"):
            raise ValueError(f"unknown true_p mode {self.env.true_p!r}")
        if self.env.backend not in ("auto", "host", "device"):
            raise ValueError(f"unknown env backend {self.env.backend!r}")
        if self.eval.health not in ("off", "record", "halt"):
            raise ValueError(f"unknown health mode {self.eval.health!r}; "
                             "expected 'off', 'record' or 'halt'")
        if self.train is not None and self.train.aggregator not in AGGREGATORS:
            raise ValueError(
                f"unknown aggregator {self.train.aggregator!r}; "
                f"available: {AGGREGATORS}")
        if self.shard is not None and self.shard.seeds > 1 \
                and len(self.seeds) % self.shard.seeds != 0:
            raise ValueError(
                f"ShardSpec.seeds={self.shard.seeds} must divide the "
                f"{len(self.seeds)} experiment seeds")

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return _spec_dict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        return _from_dict(cls, d, nested=(("policy", PolicySpec),
                                          ("env", EnvSpec),
                                          ("train", TrainSpec),
                                          ("eval", EvalSpec),
                                          ("shard", ShardSpec),
                                          ("obs", ObsSpec)))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    # -- grids -------------------------------------------------------------

    def grid(self, **axes) -> "ExperimentGrid":
        """Config grid over this spec: ``spec.grid(budget=[...],
        deadline=[...], policy=[...])``. Axis order is the kwargs order;
        the last axis varies fastest in ``expand()``."""
        for name in axes:
            if name not in GRID_AXES:
                raise KeyError(f"unknown grid axis {name!r}; available: "
                               f"{tuple(sorted(GRID_AXES))}")
        return ExperimentGrid(
            base=self,
            axes=tuple((name, tuple(values))
                       for name, values in axes.items()))


# Eq. 3 aggregation rules (the reference's fed/robust.py)
AGGREGATORS = ("mean", "trimmed_mean", "median", "clipped")


def _set_policy_option(spec: "ExperimentSpec", key: str,
                       value) -> "ExperimentSpec":
    opts = dict(spec.policy.options)
    opts[key] = value
    return replace(spec, policy=replace(spec.policy, options=_pairs(opts)))


def _set_fault(spec: "ExperimentSpec", **kw) -> "ExperimentSpec":
    faults = replace(spec.env.faults or FaultSpec(), **kw)
    return replace(spec, env=replace(spec.env, faults=faults))


# axis name -> (batchable?, apply(spec, value) -> spec). Batchable axes
# preserve every array shape, so their cells can stack next to the seed
# axis in one run (``run_rounds_grid``, ``run_bandit_device_grid``; the
# COCS hypercube axes ``h_t``/``alpha`` through ``run_rounds_grid_params``
# over a padded state); the rest run sequentially per cell.
GRID_AXES: Dict[str, Tuple[bool, Any]] = {
    "policy": (False, lambda s, v: replace(
        s, policy=v if isinstance(v, PolicySpec)
        else replace(s.policy, name=str(v), options=()))),
    "budget": (True, lambda s, v: replace(
        s, policy=replace(s.policy, budget=float(v)))),
    "deadline": (True, lambda s, v: replace(
        s, env=replace(s.env, deadline=float(v)))),
    "h_t": (True, lambda s, v: _set_policy_option(s, "h_t", int(v))),
    "alpha": (True, lambda s, v: _set_policy_option(s, "alpha", float(v))),
    "scenario": (False, lambda s, v: replace(
        s, env=replace(s.env, scenario=str(v)))),
    "true_p": (False, lambda s, v: replace(
        s, env=replace(s.env, true_p=str(v)))),
    "model": (False, lambda s, v: replace(
        s, train=replace(s.train or TrainSpec(), model=str(v)))),
    "horizon": (False, lambda s, v: replace(s, horizon=int(v))),
    # fault / robustness axes (sequential: faults change realized rounds
    # and aggregation changes the training computation, not just shapes)
    "corrupt_rate": (False, lambda s, v: _set_fault(
        s, corrupt_rate=float(v))),
    "dropout_rate": (False, lambda s, v: _set_fault(
        s, dropout_rate=float(v))),
    "aggregator": (False, lambda s, v: replace(
        s, train=replace(s.train or TrainSpec(), aggregator=str(v)))),
}


def env_spec_from_config(cfg, scenario: str = "paper",
                         backend: str = "auto",
                         deadline: Optional[float] = None,
                         true_p: str = "mc") -> EnvSpec:
    """``EnvSpec`` for an in-memory ``HFLExperimentConfig`` object.

    Serializable specs reference configs by *name*; an ad-hoc config
    (e.g. ``dc.replace(MNIST_CONVEX, lr=0.01)``) is expressed as its
    registered base plus field ``overrides``, so that it stays
    round-trippable.
    """
    from repro_torch.configs.paper_hfl import CONFIGS, MNIST_CONVEX

    base = CONFIGS.get(getattr(cfg, "name", ""), MNIST_CONVEX)
    overrides = tuple(
        (f.name, getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)
        if getattr(cfg, f.name) != getattr(base, f.name))
    return EnvSpec(scenario=scenario, backend=backend, config=base.name,
                   deadline=deadline, true_p=true_p, overrides=overrides)


@dataclass(frozen=True)
class ExperimentGrid:
    """A base spec plus named config axes; itself JSON-round-trippable.

    ``expand()`` materializes the cells as full ``ExperimentSpec``s in C
    order (last axis fastest).
    """
    base: ExperimentSpec
    axes: Tuple[Tuple[str, Tuple[Any, ...]], ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(values) for _, values in self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    def coords(self) -> Tuple[Tuple[Any, ...], ...]:
        """Axis-value coordinates of every cell, in expansion order."""
        return tuple(itertools.product(*(v for _, v in self.axes)))

    def expand(self) -> Tuple[ExperimentSpec, ...]:
        cells = []
        for combo in self.coords():
            spec = self.base
            for (name, _), value in zip(self.axes, combo):
                spec = GRID_AXES[name][1](spec, value)
            cells.append(spec)
        return tuple(cells)

    def to_dict(self) -> Dict[str, Any]:
        return {"base": self.base.to_dict(),
                "axes": [[name, list(values)] for name, values in self.axes]}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentGrid":
        return cls(base=ExperimentSpec.from_dict(d["base"]),
                   axes=tuple((str(name), tuple(values))
                              for name, values in d["axes"]))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentGrid":
        return cls.from_dict(json.loads(s))
