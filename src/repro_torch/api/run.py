"""``repro_torch.run(spec) -> RunResult``: one entry point for every
tier.

The facade reads a declarative ``ExperimentSpec`` (the same JSON the
reference's ``repro.run`` reads) and picks the engine by the
reference's rules:

    tier 1  bandit-only        no ``TrainSpec``: the policy over realized
                               rounds (``policies.engine``; the host
                               env's rounds from the rollout cache), or
                               ``sim.engine.run_bandit_device`` on a
                               device env; host-state policies take
                               ``run_rounds_host`` one seed at a time
    tier 2  host-loop          training with a host-state policy (CUCB,
                               LinUCB, phased COCS): one seed and one
                               round at a time through
                               ``fed.batched.train_round``
    tier 3  fused              training with a tensor policy on a host
                               env: ``experiment.fused.block_host``
    tier 4  device-env fused   training with a tensor policy on a device
                               env: ``experiment.fused.block_device``

and returns per-seed metrics with their provenance: the resolved spec,
the tier that ran, the env backend and the draw-schedule id. Backend
resolution is the reference's: ``backend="auto"`` takes the device
simulator exactly when the scenario exists only there. ``run`` also
takes an ``ExperimentGrid`` (``spec.grid(...)``) and batches its
budget, deadline and hypercube cells (``api.grid``).

Faults (``EnvSpec.faults``) act in either env's rounds (dropout,
stragglers, ES outages) and in the training tiers' updates (corruption,
from the env seeds); ``TrainSpec.aggregator`` picks the Eq. 3 rule
(``fed.robust``) and ``TrainSpec.transposed_gemm`` the reference's
``logreg-t`` layout.

Tiers 3 and 4 take the reference's resilience and observability:
``EvalSpec.checkpoint_dir``/``resume`` (one atomic checkpoint an eval
interval, a bitwise resume), ``EvalSpec.health`` ("record" or "halt" on
a non-finite carry) and ``ObsSpec`` (``telemetry`` taps into
``RunResult.telemetry``, a ``trace`` JSONL span log with its
``perfetto`` export, a ``torch.profiler`` trace into ``jax_profiler``).
Tiers 1 and 2 run the tracer too and report ``telemetry=None``.

A ``ShardSpec`` of more than one shard runs tier 4 on the client-sharded
cohort engine (``repro_torch.mesh.sweep_sharded``): every rank of a
``torch.distributed`` group of ``clients * seeds`` ranks calls ``run``
and gets the same full ``RunResult``; without such a group it raises
``ValueError`` saying how to start the ranks. Any other tier raises the
reference's ``ValueError``, and what the reference's sharded engine
refuses (corruption faults, a policy without ``pair_values``, a robust
aggregator, an MoE model, an N or S the mesh does not divide) raises
alike, all before any work; like the reference's sharded path it
ignores ``checkpoint_dir``, ``resume`` and ``health``. ``shard_seeds``
splits the fused tiers' seeds over the group's ranks where they divide,
and warns and runs unsharded where not (one process included). Only
rank 0 of a group writes a trace or a profile.

``device=None`` runs on CUDA (rank r of a process group on
``cuda:(r % device_count)``) and raises without a CUDA device; pass
``device="cpu"`` for the plain PyTorch path. On CUDA every kernel
launches, so ``use_kernel=False`` (the reference's plain route) is
refused there; on the CPU the plain versions run whatever it says. A
host env computes its rounds on the CPU in float64, as the reference's
does, and its stacked rounds then go to the run's device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.spec import (EnvSpec, ExperimentGrid, ExperimentSpec,
                                  PolicySpec)
from repro_torch.envs import cached_rollout
from repro_torch.obs import trace as obs_trace

# the reference's host scenarios (``repro.envs.SCENARIOS``) and its
# device presets (``repro.sim.spec.PRESETS``), by name
HOST_SCENARIOS = ("paper", "static-clients", "high-mobility",
                  "tiered-pricing", "flash-crowd")
MESH_PRESETS = ("metropolis-100k", "metropolis-1m")
DEVICE_PRESETS = HOST_SCENARIOS + ("metropolis-1k", "bursty-arrival") \
    + MESH_PRESETS


@dataclass
class RunResult:
    """Structured result of one ``run``: metrics + provenance.

    Leading axes: S seeds (in ``spec.seeds`` order), T rounds, E evals.
    ``accuracy``/``loss``/``eval_rounds`` are None for bandit-only runs.
    ``batched_axes`` names the grid axes the run was batched over (empty
    outside ``api.grid``). ``health`` is the guard's report on tiers 3
    and 4 when ``EvalSpec.health`` is on (``{"checked": int, "events":
    [...]}``); ``telemetry`` the taps' ``{"series", "totals",
    "summary"}`` on tiers 3 and 4 with ``ObsSpec.telemetry``; both None
    otherwise.
    """
    spec: ExperimentSpec                 # resolved spec (provenance)
    tier: int                            # 1..4, see the module docstring
    env_backend: str                     # "host" | "device"
    draw_schedule: str                   # randomness-contract id
    selections: np.ndarray               # (S, T, N) int
    utilities: np.ndarray                # (S, T)
    participants: np.ndarray             # (S, T)
    explored: np.ndarray                 # (S, T) bool
    eval_rounds: Optional[np.ndarray] = None   # (E,) 1-based round ids
    accuracy: Optional[np.ndarray] = None      # (S, E)
    loss: Optional[np.ndarray] = None          # (S, E)
    batched_axes: Tuple[str, ...] = ()
    health: Optional[dict] = None
    telemetry: Optional[dict] = None

    def final_accuracy(self) -> np.ndarray:
        if self.accuracy is None:
            raise ValueError("bandit-only run: no accuracy recorded "
                             "(add a TrainSpec)")
        return self.accuracy[:, -1]

    def cumulative_utility(self) -> np.ndarray:
        return np.cumsum(self.utilities, axis=1)


# -- spec resolution ---------------------------------------------------------


def _device_only(scenario: str) -> bool:
    return scenario in DEVICE_PRESETS and scenario not in HOST_SCENARIOS


def resolve_config(env_spec: EnvSpec):
    """The ``HFLExperimentConfig`` an ``EnvSpec`` implies (named config
    or the scenario's default, then overrides and deadline)."""
    from repro_torch.configs.paper_hfl import MNIST_CONVEX, get_config
    from repro_torch.sim.spec import PRESETS

    scen = env_spec.scenario.lower()
    if env_spec.config is not None:
        cfg = get_config(env_spec.config)
    elif scen in PRESETS:
        cfg = PRESETS[scen][0]
    else:
        cfg = MNIST_CONVEX
    if env_spec.overrides:
        cfg = dataclasses.replace(cfg, **dict(env_spec.overrides))
    if env_spec.deadline is not None:
        cfg = dataclasses.replace(cfg, deadline_s=float(env_spec.deadline))
    return cfg


def _env_backend(env_spec: EnvSpec) -> str:
    """``"device"`` or ``"host"``, by the reference's rule."""
    scen = env_spec.scenario.lower()
    use_device = (env_spec.backend == "device"
                  or (env_spec.backend == "auto" and _device_only(scen)))
    return "device" if use_device else "host"


def build_env(env_spec: EnvSpec):
    """EnvSpec -> ``envs.HFLEnv`` (host) | ``sim.spec.DeviceEnv``."""
    from repro_torch import envs
    from repro_torch.sim import spec as simspec

    scen = env_spec.scenario.lower()
    cfg = resolve_config(env_spec)
    if _env_backend(env_spec) == "device":
        return simspec.make(scen, cfg, mc_true_p=env_spec.mc_true_p,
                            true_p=env_spec.true_p, faults=env_spec.faults)
    return envs.make(scen, cfg, true_p=env_spec.true_p,
                     faults=env_spec.faults)


def build_policy(policy_spec: PolicySpec, cfg, horizon: int):
    """PolicySpec -> registry policy (the config's COCS knobs unless
    ``options`` override them)."""
    from repro_torch import policies
    from repro_torch.core.utility import _policy_kwargs

    pspec = policies.PolicySpec.from_experiment(
        cfg, horizon, budget=policy_spec.budget)
    kw = dict(_policy_kwargs(cfg, policy_spec.name.lower()))
    kw.update(dict(policy_spec.options))
    return policies.make(policy_spec.name, pspec, **kw)


def select_tier(spec: ExperimentSpec, policy, env) -> int:
    from repro_torch.sim.spec import DeviceEnv
    return _tier(spec, policy, isinstance(env, DeviceEnv))


def _tier(spec: ExperimentSpec, policy, device_env: bool) -> int:
    if spec.train is None:
        return 1
    if not getattr(policy, "tensor_capable", False):
        return 2
    return 4 if device_env else 3


def sharded(spec: ExperimentSpec) -> bool:
    """True when the spec's ``ShardSpec`` splits an axis."""
    shard = spec.shard
    return shard is not None and (shard.clients > 1 or shard.seeds > 1)


def check_shard(spec: ExperimentSpec) -> None:
    """A sharded spec's refusals, from the spec alone (no env is built):
    the reference's ``ValueError`` off tier 4, what its sharded engine
    refuses (``mesh.runner.check_sharded``), then a process group of
    another size than the mesh (``mesh.topology.check_ranks``)."""
    if not sharded(spec):
        return
    from repro_torch.mesh.runner import check_sharded

    shard = spec.shard
    cfg = resolve_config(spec.env)
    policy = build_policy(spec.policy, cfg, spec.horizon)
    device_env = _env_backend(spec.env) == "device"
    tier = _tier(spec, policy, device_env)
    if tier != 4:
        raise ValueError(
            f"ShardSpec(clients={shard.clients}, seeds={shard.seeds}) "
            "needs the device-env fused tier (tier 4): a device "
            "backend env and a tensor policy; this spec resolved to "
            f"tier {tier}")
    check_sharded(policy, shard, device_env=device_env,
                  num_clients=cfg.num_clients, n_seeds=len(spec.seeds),
                  faults=spec.env.faults, model_kind=spec.train.model_kind,
                  aggregator=spec.train.aggregator)
    from repro_torch.mesh.topology import check_ranks
    check_ranks(shard.seeds, shard.clients)


# -- the facade --------------------------------------------------------------


def _check_device(spec: ExperimentSpec, dev) -> None:
    if dev.type == "cuda":
        for what, sub in (("EnvSpec", spec.env), ("TrainSpec", spec.train)):
            if sub is not None and sub.use_kernel is False:
                raise ValueError(
                    f"{what}.use_kernel=False asks for the plain route, "
                    "which the port runs on the CPU only (device='cpu')")


def run(spec, *, data=None, device=None):
    """Run one ``ExperimentSpec`` (-> ``RunResult``) or an
    ``ExperimentGrid`` (-> ``api.grid.GridResult``).

    ``data`` optionally supplies the ``FederatedDataset`` of a training
    tier (default: synthetic data keyed on the model kind). ``device``
    is the torch device: ``None`` means CUDA and raises without it.
    The run is traced as its ``spec.obs`` asks (``obs.trace``)."""
    if isinstance(spec, ExperimentGrid):
        from repro_torch.api.grid import run_grid
        return run_grid(spec, data=data, device=device)
    if not isinstance(spec, ExperimentSpec):
        raise TypeError("repro_torch.run expects an ExperimentSpec or "
                        f"ExperimentGrid, got {type(spec).__name__}")
    from repro_torch.kernels.common import resolve_device

    from repro_torch.launch.mesh import rank_device

    check_shard(spec)
    dev = resolve_device(device) if device is not None else rank_device()
    _check_device(spec, dev)
    obs = spec.obs
    if _rank() != 0:
        # one trace and one profile a group: rank 0's
        obs = dataclasses.replace(obs, trace=None, perfetto=None,
                                  jax_profiler=None)
    with obs_trace.run_tracing(obs):
        return _run_spec(spec, data, dev)


def _run_spec(spec: ExperimentSpec, data, dev) -> RunResult:
    from repro_torch.sim.draws import SCHEDULE_ID
    from repro_torch.sim.spec import DeviceEnv

    with obs_trace.span("run.resolve", policy=spec.policy.name,
                        scenario=spec.env.scenario) as at:
        env = build_env(spec.env)
        policy = build_policy(spec.policy, env.cfg, spec.horizon)
        tier = select_tier(spec, policy, env)
        backend = "device" if isinstance(env, DeviceEnv) else "host"
        at["tier"], at["backend"] = tier, backend
    seeds = [int(s) for s in spec.seeds]
    pol_seeds = [s + spec.policy.seed_offset for s in seeds]
    common = dict(spec=spec, tier=tier, env_backend=backend,
                  draw_schedule=SCHEDULE_ID)
    if tier == 1:
        # the bandit engines carry no training taps: telemetry is None
        with obs_trace.span("run.dispatch", tier=tier):
            out = _run_bandit(policy, env, seeds, pol_seeds, spec.horizon,
                              backend, dev)
        return RunResult(**common, **out)
    name = spec.policy.name
    if sharded(spec):
        res = _run_sharded(spec, policy, env, seeds, data, dev)
    else:
        with obs_trace.span("run.dispatch", tier=tier, policy=name):
            res = _sweep(spec, policy, env, seeds, data, dev)
    telemetry = res.telemetry.get(name)
    if telemetry is not None and obs_trace.active() is not None \
            and _rank() == 0:
        _emit_telemetry_event(name, telemetry)
    return RunResult(**common, selections=res.selections[name],
                     utilities=res.utilities[name],
                     participants=res.participants[name],
                     explored=res.explored[name],
                     eval_rounds=np.asarray(res.eval_rounds),
                     accuracy=res.accuracy[name], loss=res.loss[name],
                     health=res.health.get(name), telemetry=telemetry)


def _rank() -> int:
    """This process's rank in the default process group (0 without)."""
    from repro_torch.launch.mesh import world_size
    return torch.distributed.get_rank() if world_size() > 1 else 0


def _run_sharded(spec: ExperimentSpec, policy, env, seeds, data, dev):
    """Tier 4 on the cohort mesh; like the reference's sharded path it
    takes no checkpoints, resume or health guard."""
    from repro_torch.mesh.runner import sweep_sharded

    shard, name = spec.shard, spec.policy.name
    with obs_trace.span("run.dispatch", tier=4, policy=name,
                        mesh=f"{shard.seeds}x{shard.clients}"):
        return sweep_sharded(
            {name: policy}, env, seeds, spec.horizon, shard=shard,
            model_kind=spec.train.model_kind,
            batch_size=spec.train.batch_size,
            batches_per_epoch=spec.train.batches_per_epoch,
            eval_every=spec.eval.eval_every, data=data,
            slots_per_es=spec.train.slots_per_es,
            policy_seed_offset=spec.policy.seed_offset,
            aggregator=spec.train.aggregator,
            trim_frac=spec.train.trim_frac,
            telemetry=spec.obs.telemetry, device=dev)


def _sweep(spec: ExperimentSpec, policy, env, seeds, data, dev):
    from repro_torch.experiment.sweep import sweep_experiments

    name = spec.policy.name
    return sweep_experiments(
            {name: policy}, env, seeds, spec.horizon,
            model_kind=spec.train.model_kind,
            batch_size=spec.train.batch_size,
            batches_per_epoch=spec.train.batches_per_epoch,
            eval_every=spec.eval.eval_every, data=data,
            slots_per_es=spec.train.slots_per_es,
            policy_seed_offset=spec.policy.seed_offset,
            aggregator=spec.train.aggregator,
            trim_frac=spec.train.trim_frac,
            checkpoint_dir=spec.eval.checkpoint_dir,
            resume=spec.eval.resume, health=spec.eval.health,
            telemetry=spec.obs.telemetry, shard_seeds=spec.shard_seeds,
            device=dev)


def _emit_telemetry_event(name: str, telemetry: dict) -> None:
    """The run's telemetry profile as a trace event, which the report
    (``python -m repro_torch.obs report``) renders."""
    def series(key):
        return [round(float(v), 4)
                for v in np.mean(telemetry["series"][key], axis=0)]
    obs_trace.event("telemetry", policy=name,
                    summary=telemetry["summary"],
                    participation=series("arrived"),
                    explored=series("underexplored"),
                    ucb_width=series("ucb_width"))


_FIELDS = ("selections", "utilities", "participants", "explored")


def _run_bandit(policy, env, seeds: Sequence[int], pol_seeds: Sequence[int],
                horizon: int, backend: str, dev) -> dict:
    """Tier-1 engines, by the reference's dispatch: a device env runs the
    device bandit engine; on a host env a tensor policy with one seed
    runs ``run_rounds`` and with several ``run_rounds_multi_seed`` on the
    realized rounds; a host-state policy runs ``run_rounds_host`` seed
    by seed."""
    from repro_torch import policies as P
    from repro_torch.experiment.sweep import host_rounds
    from repro_torch.policies.base import round_from_arrays
    from repro_torch.sim.engine import run_bandit_device

    if policy.tensor_capable:
        if backend == "device":
            out = run_bandit_device(policy, env.spec, seeds, horizon,
                                    policy_seeds=pol_seeds, device=dev)
        else:
            batch = round_from_arrays(env.rollout_multi(seeds, horizon), dev)
            if len(seeds) == 1:
                one = P.run_rounds(policy, P.Round(*(f[0] for f in batch)),
                                   seed=pol_seeds[0])
                out = {k: one[k][None] for k in _FIELDS}
            else:
                out = P.run_rounds_multi_seed(policy, batch, pol_seeds)
    else:
        per_seed = [P.run_rounds_host(policy,
                                      host_rounds(env, s, horizon, dev),
                                      seed=ps)
                    for s, ps in zip(seeds, pol_seeds)]
        out = {k: np.stack([o[k] for o in per_seed]) for k in _FIELDS}
    return {k: np.asarray(out[k]) for k in _FIELDS}


__all__ = ["RunResult", "build_env", "build_policy", "cached_rollout",
           "check_shard", "resolve_config", "run", "select_tier",
           "sharded"]
