"""The shipped named suites (the reference's ``trials/suites.py``).

``paper-fig3``: the Fig. 3a/3b strongly-convex bandit-only panel, all
five policies (the per-policy seed offsets of ``POLICY_TABLE``) on the
paper scenario at the quick-benchmark horizon.

``paper-fig4-quick``: the Fig. 4a training panel at quick scale with a
budget axis: COCS, Oracle and Random run tier 3 with the budget cells
batched next to the seed axis; CUCB and LinUCB run tier 2, a cell at a
time, behind the same records. ``@smoke`` is the tiny-horizon variant.

``robustness-panel``: the fault-injection panel, COCS, Oracle and Random
over a ``corrupt_rate`` x ``aggregator`` grid (``sim.faults``,
``fed.robust``), scoring final accuracy and oracle regret per cell.
Under >= 20% update corruption the robust Eq. 3 rules (trimmed mean,
median) beat the paper's plain mean.

Names, specs and descriptions are the reference's strings, so each
suite's ``to_json()`` is the reference's.
"""
from __future__ import annotations

from repro_torch.api.spec import (EnvSpec, EvalSpec, ExperimentSpec,
                                  PolicySpec, TrainSpec)
from repro_torch.core.utility import POLICY_TABLE
from repro_torch.trials.suite import TrialSuite, register_suite


def _panel_policies():
    """The paper's five-policy comparison row, with the per-policy seed
    offsets of ``POLICY_TABLE``."""
    return tuple((display, PolicySpec(name=reg, seed_offset=off))
                 for display, (reg, off) in POLICY_TABLE.items())


PAPER_FIG3 = register_suite(TrialSuite(
    name="paper-fig3",
    base=ExperimentSpec(
        env=EnvSpec(scenario="paper", config="mnist-convex"),
        horizon=400, seeds=(1,)),
    policies=_panel_policies(),
    oracle="Oracle",
    smoke=(("horizon", 60),),
    description="Fig. 3a/3b: bandit-only cumulative utility + "
                "regret-vs-oracle of the 5 policies, strongly convex "
                "(linear utility), quick-benchmark horizon."))


PAPER_FIG4_QUICK = register_suite(TrialSuite(
    name="paper-fig4-quick",
    base=ExperimentSpec(
        env=EnvSpec(scenario="paper", config="mnist-convex",
                    overrides=(("lr", 0.01),)),
        train=TrainSpec(model="logreg"),
        eval=EvalSpec(eval_every=5),
        horizon=40, seeds=(0,)),
    policies=_panel_policies(),
    axes=(("budget", (3.5, 5.0)),),
    oracle="Oracle",
    smoke=(("horizon", 12), ("eval_every", 6)),
    description="Fig. 4a at quick scale with a device-batched budget "
                "axis: HFL training accuracy + utility/regret under the "
                "5 policies (fused tier for jax policies, host-loop "
                "fallback for CUCB/LinUCB)."))


def _robustness_policies():
    """COCS against Oracle and Random at a budget large enough (8.0
    against the paper's 3.5) that per-ES cohorts reach the >= 3 clients
    the robust order statistics need to differ from the mean."""
    return tuple(
        (display, PolicySpec(name=POLICY_TABLE[display][0], budget=8.0,
                             seed_offset=POLICY_TABLE[display][1]))
        for display in ("COCS", "Oracle", "Random"))


ROBUSTNESS_PANEL = register_suite(TrialSuite(
    name="robustness-panel",
    base=ExperimentSpec(
        env=EnvSpec(scenario="paper", config="mnist-convex",
                    overrides=(("lr", 0.01),)),
        train=TrainSpec(model="logreg"),
        eval=EvalSpec(eval_every=5),
        horizon=40, seeds=(0,)),
    policies=_robustness_policies(),
    axes=(("corrupt_rate", (0.0, 0.25)),
          ("aggregator", ("mean", "trimmed_mean", "median"))),
    oracle="Oracle",
    smoke=(("horizon", 12), ("eval_every", 6)),
    description="Fault-injection panel: COCS vs Oracle/Random final "
                "accuracy and regret across a corrupt_rate grid under "
                "each Eq. 3 aggregation rule — with >= 20% update "
                "corruption the robust rules (trimmed mean / median) "
                "must beat the paper's plain mean, which collapses."))


__all__ = ["PAPER_FIG3", "PAPER_FIG4_QUICK", "ROBUSTNESS_PANEL"]
