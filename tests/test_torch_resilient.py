"""Resilient execution of the port's training tiers against the
reference's (``tests/test_resilient.py`` at its sizes: ``paper``,
horizon 16, ``eval_every`` 4, seeds (0, 1)).

A run killed after interval 1, 2 or 3 (``stop_after_blocks``) and
resumed from its checkpoint equals the port's uninterrupted run bitwise
in selections, utilities, participants, explored, accuracy and loss, on
tiers 3 and 4 for COCS, the Oracle and Random; the uninterrupted run
equals ``repro.run`` (selections bitwise, accuracy within
``SWEEP_ACC_TOL``). Checkpointing does not perturb a run; a checkpoint
of another run, of the other telemetry mode or of the other device type
is refused. The health guard records no event on a clean run and, at
``lr=nan``, the reference's events with its leaf names; ``halt`` raises.

The runs train at lr 0.01, as the port's other parity tests do: at the
config's own 0.005, seed 1's last evaluation holds a test sample whose
two largest logits are equal in the port's float32, and the argmax tie
breaks the other way on the reference (accuracy 1/2000 apart, loss
within 2.4e-7; ROADMAP queue C). The reference runs each policy
once and COCS on both tiers (``test_torch_experiment.py`` holds the
three policies' sweeps on ``device:paper``), which keeps the file near
a minute."""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from _torch_parity import one_torch_thread, runs_agree  # noqa: E402,F401
from repro import api as JA  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch.api.run import build_env, build_policy  # noqa: E402
from repro_torch.checkpoint import (latest_checkpoint,  # noqa: E402
                                    restore_pytree, save_pytree)
from repro_torch.experiment.sweep import (SimulatedKill,  # noqa: E402
                                          sweep_experiments)
from repro_torch.obs import ObsSpec  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HORIZON, EVERY = 16, 4          # 4 checkpointed eval intervals
SEEDS = (0, 1)
POLICIES = ("COCS", "Oracle", "Random")
TIERS = {3: "auto", 4: "device"}
FIELDS = ("selections", "utilities", "participants", "explored",
          "accuracy", "loss")


def _spec(policy="COCS", tier=3, checkpoint_dir=None, resume=False,
          health="off", horizon=HORIZON, lr=0.01, telemetry=False):
    overrides = (("lr", lr),)
    return TA.ExperimentSpec(
        env=TA.EnvSpec(scenario="paper", backend=TIERS[tier],
                       overrides=overrides),
        policy=TA.PolicySpec(name=policy),
        train=TA.TrainSpec(model="logreg"),
        eval=TA.EvalSpec(eval_every=EVERY, checkpoint_dir=checkpoint_dir,
                         resume=resume, health=health),
        obs=ObsSpec(telemetry=telemetry), horizon=horizon, seeds=SEEDS)


def _run(spec):
    return repro_torch.run(spec, device="cpu")


def _kill_after(spec, ckpt_dir, blocks, telemetry=False):
    """The facade's construction, killed after ``blocks`` intervals."""
    env = build_env(spec.env)
    pol = build_policy(spec.policy, env.cfg, spec.horizon)
    with pytest.raises(SimulatedKill):
        sweep_experiments({spec.policy.name: pol}, env, list(spec.seeds),
                          spec.horizon, eval_every=spec.eval.eval_every,
                          checkpoint_dir=ckpt_dir, telemetry=telemetry,
                          stop_after_blocks=blocks, device="cpu")


def _assert_same_run(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.fixture(scope="module")
def uninterrupted():
    return {(p, t): _run(_spec(p, t)) for p in POLICIES for t in TIERS}


@pytest.mark.parametrize("policy,tier", [("COCS", 3), ("COCS", 4),
                                         ("Oracle", 3), ("Random", 3)])
def test_uninterrupted_run_equals_reference(uninterrupted, policy, tier):
    spec = _spec(policy, tier)
    want = repro.run(JA.ExperimentSpec.from_json(spec.to_json()))
    got = uninterrupted[policy, tier]
    assert got.tier == tier
    runs_agree(want, got)


def test_checkpointing_does_not_perturb_the_run(tmp_path, uninterrupted):
    """One checkpoint an interval in the policy's subdirectory, and the
    run is bitwise the plain one."""
    ck = str(tmp_path / "ck")
    res = _run(_spec(checkpoint_dir=ck))
    _assert_same_run(uninterrupted["COCS", 3], res)
    files = sorted(os.listdir(os.path.join(ck, "COCS")))
    assert files == [f"ckpt_{i:08d}.pt" for i in range(1, 5)]
    payload = restore_pytree(os.path.join(ck, "COCS", files[-1]))
    assert payload["blocks_done"] == HORIZON // EVERY
    assert len(payload["outs"]) == HORIZON // EVERY
    assert json.loads(payload["fingerprint"])["device"] == "cpu"


@pytest.mark.parametrize("kill_after", [1, 2, 3])
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("policy", POLICIES)
def test_kill_and_resume_bitwise(tmp_path, uninterrupted, policy, tier,
                                 kill_after):
    """Killed after the first, middle or last-but-one interval, the
    resumed run reproduces the uninterrupted one bitwise."""
    ck = str(tmp_path / "ck")
    _kill_after(_spec(policy, tier), ck, kill_after)
    assert latest_checkpoint(os.path.join(ck, policy)).endswith(
        f"ckpt_{kill_after:08d}.pt")
    resumed = _run(_spec(policy, tier, checkpoint_dir=ck, resume=True))
    _assert_same_run(uninterrupted[policy, tier], resumed)
    # the resumed run wrote the remaining intervals' checkpoints
    assert latest_checkpoint(os.path.join(ck, policy)).endswith(
        f"ckpt_{HORIZON // EVERY:08d}.pt")


def test_resume_with_empty_dir_runs_fresh(tmp_path, uninterrupted):
    res = _run(_spec(checkpoint_dir=str(tmp_path / "nothing-here"),
                     resume=True))
    _assert_same_run(uninterrupted["COCS", 3], res)


def test_resume_rejects_foreign_checkpoint(tmp_path):
    """Another horizon, hence other interval bounds: refused."""
    ck = str(tmp_path / "ck")
    _kill_after(_spec(), ck, 1)
    with pytest.raises(ValueError, match="different run"):
        _run(_spec(horizon=24, checkpoint_dir=ck, resume=True))


def test_resume_rejects_other_telemetry_mode(tmp_path):
    ck = str(tmp_path / "ck")
    _kill_after(_spec(telemetry=True), ck, 1, telemetry=True)
    with pytest.raises(ValueError, match="different run"):
        _run(_spec(checkpoint_dir=ck, resume=True))


def test_resume_rejects_other_device_type(tmp_path):
    """A checkpoint that names CUDA in its fingerprint (what a run on
    the card writes) is refused on the CPU: the two device types' runs
    are not bitwise equal. ``test_torch_api_cuda.py`` writes one on the
    card."""
    ck = str(tmp_path / "ck")
    _kill_after(_spec(tier=4), ck, 1)
    path = latest_checkpoint(os.path.join(ck, "COCS"))
    payload = restore_pytree(path)
    fp = json.loads(payload["fingerprint"])
    fp["device"] = "cuda"
    payload["fingerprint"] = json.dumps(fp, sort_keys=True)
    save_pytree(path, payload)
    with pytest.raises(ValueError, match="device type"):
        _run(_spec(tier=4, checkpoint_dir=ck, resume=True))


# -- the health guard ---------------------------------------------------------


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_health_record_clean_run(uninterrupted, tier):
    res = _run(_spec(tier=tier, health="record"))
    assert res.health == {"checked": HORIZON // EVERY, "events": []}
    _assert_same_run(uninterrupted["COCS", tier], res)


def test_health_record_equals_reference():
    """A NaN learning rate poisons the carry: both packages record the
    same (interval, round_end, bad leaves) events, and the run ends."""
    spec = _spec(horizon=8, lr=float("nan"), health="record")
    want = repro.run(JA.ExperimentSpec.from_json(spec.to_json())).health
    got = _run(spec).health
    assert got == want
    assert got["checked"] == 2 and len(got["events"]) == 2
    assert got["events"][0]["round_end"] == 4
    assert "carry['edge']['w']" in got["events"][0]["bad"]


def test_health_record_tier4_names_leaves():
    res = _run(_spec(tier=4, horizon=8, lr=float("nan"), health="record"))
    bad = res.health["events"][0]["bad"]
    assert bad == ["carry['edge']['b']", "carry['edge']['w']",
                   "out['loss']"]


def test_health_halt_raises():
    with pytest.raises(RuntimeError, match="non-finite"):
        _run(_spec(horizon=8, lr=float("nan"), health="halt"))


def test_health_rejects_unknown_mode():
    with pytest.raises(ValueError, match="health"):
        sweep_experiments(["random"], "paper", [0], 4, eval_every=2,
                          health="sometimes", device="cpu")
