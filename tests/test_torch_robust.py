"""The robust Eq. 3 rules (``repro_torch.fed.robust``) and update
corruption (``fed.batched.corrupt_scale``) against the reference's
``repro.fed.robust`` and fault draws on the CPU.

Cohorts of 0, 1, 2, 3, 4 and 7 clients with padded slots in between, on
the reference's rank-3 ``(B, M, S)`` layout and its rank-2 ``(M, S)``
one: the median is bitwise the reference's (an exact order statistic);
the trimmed mean and the clipped mean differ only by reduction order,
within ``ROBUST_RTOL`` of the leaf's largest magnitude (measured 5e-8
and 1.8e-7 over 30 draws); ``mean`` is bitwise ``masked_aggregate_rows``.
Corruption reaches training only: selections, utilities and explored
stay bitwise the clean run's while the accuracy moves.

Through the facade against ``repro.run`` (``runs_agree``): Random's
cells of the ``robustness-panel`` suite at ``@smoke`` (corrupt_rate 0.25
under each rule; COCS's are in ``test_torch_faults_api.py``), tier 4 on
``device:paper`` with all four processes under ``clipped``, and
``TrainSpec.transposed_gemm`` (``logreg-t``), whose local-SGD deltas
from zeros are the ``logreg`` deltas transposed within the reference's
own ``LOGREG_T_ATOL`` (not bitwise: the two products sum in another
order)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from _torch_parity import (bitwise, one_torch_thread,  # noqa: E402,F401
                           panel_cells, runs_agree, t_)
from repro import api as JA  # noqa: E402
from repro.fed.robust import \
    robust_aggregate_stacked as jax_robust  # noqa: E402
from repro.sim import draws as jdraws  # noqa: E402
from repro.sim import faults as jfaults  # noqa: E402
from repro.trials.suites import ROBUSTNESS_PANEL  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch.configs.paper_hfl import MNIST_CONVEX  # noqa: E402
from repro_torch.fed import robust  # noqa: E402
from repro_torch.fed.batched import corrupt_scale  # noqa: E402
from repro_torch.kernels.masked_aggregate.ops import \
    masked_aggregate_rows  # noqa: E402
from repro_torch.sim.faults import FaultSpec  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the trimmed and clipped means against the reference: |want - got| over
# the largest |want| of the leaf (their sums and norms reduce in another
# order)
ROBUST_RTOL = 1e-6
# the reference's own bound for its logreg-t deltas against logreg's
# (tests/test_transposed_gemm.py); measured 1.5e-8 on the CPU
LOGREG_T_ATOL = 1e-6
COHORTS = (0, 1, 2, 3, 4, 7)
SLOTS = 8


def _inputs(b, seed=0, weights=(1.0, 0.5, 2.0)):
    """(B, M, ...) params, (B, M, S, ...) deltas and (B, M, S) weights:
    ES j of element i holds COHORTS[(i + j) % 6] clients at scattered
    slots."""
    rng = np.random.default_rng(seed)
    m = len(COHORTS)
    w = np.zeros((b, m, SLOTS), np.float32)
    for i in range(b):
        for j in range(m):
            c = COHORTS[(i + j) % m]
            idx = rng.choice(SLOTS, c, replace=False)
            w[i, j, idx] = rng.choice(weights, c)
    p = {"w": rng.normal(size=(b, m, 20, 10)).astype(np.float32),
         "b": rng.normal(size=(b, m, 10)).astype(np.float32)}
    d = {k: (rng.normal(size=v.shape[:2] + (SLOTS,) + v.shape[2:])
             * 3.0).astype(np.float32) for k, v in p.items()}
    return p, d, w


def _port(p, d, w, **kw):
    out = robust.robust_aggregate_stacked(
        {k: t_(v) for k, v in p.items()}, {k: t_(v) for k, v in d.items()},
        t_(w), **kw)
    return {k: v.numpy() for k, v in out.items()}


def _ref(p, d, w, **kw):
    fn = jax.jit(lambda p, d, w: jax_robust(p, d, w, **kw))
    return {k: np.asarray(v) for k, v in fn(p, d, w).items()}


def _agree(agg, want, got):
    for k in want:
        if agg in ("median", "mean"):
            assert bitwise(want[k], got[k]), (agg, k)
        else:
            gap = np.abs(want[k].astype(np.float64) - got[k]).max()
            assert gap <= ROBUST_RTOL * np.abs(want[k]).max(), (agg, k, gap)


@pytest.mark.parametrize("layout", ["rank3", "rank2"])
@pytest.mark.parametrize("agg", robust.AGGREGATORS)
def test_robust_rules_match_reference(agg, layout):
    p, d, w = _inputs(2 if layout == "rank3" else 1, seed=len(agg))
    kw = dict(aggregator=agg, trim_frac=0.3)
    got = _port(p, d, w, **kw)
    if layout == "rank3":
        want = _ref(p, d, w, **kw)
    else:          # the reference's (M, S) layout of one element
        want = {k: v[None] for k, v in _ref({k: v[0] for k, v in p.items()},
                                            {k: v[0] for k, v in d.items()},
                                            w[0], **kw).items()}
    _agree(agg, want, got)
    # an ES with no contributor keeps its params, under every rule
    empty = ~(w > 0).any(-1)
    assert empty.any()
    for k in p:
        assert np.array_equal(got[k][empty], p[k][empty]), k


def test_mean_is_masked_aggregate_rows_bitwise():
    p, d, w = _inputs(2)
    tp = {k: t_(v) for k, v in p.items()}
    flat = torch.cat([t_(d[k]).reshape(2 * len(COHORTS), SLOTS, -1)
                      for k in p], dim=2)
    want = masked_aggregate_rows(tp, flat, t_(w))
    got = robust.robust_aggregate_rows(tp, flat, t_(w), aggregator="mean")
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_unknown_aggregator_raises():
    p, d, w = _inputs(1)
    with pytest.raises(ValueError, match="trimmed_mean.*median.*clipped"):
        _port(p, d, w, aggregator="max")


@pytest.mark.parametrize("agg", ["trimmed_mean", "median", "clipped"])
def test_nonfinite_updates_mirror_reference(agg):
    """A diverged update (NaN, +inf) in a filled slot: sorted values that
    are not finite count as 0, as the reference's ``_sorted_valid``."""
    p, d, w = _inputs(2, seed=7)
    d["w"][0, 4, :, 0, 0] = np.nan
    d["w"][1, 3, :, 1, 1] = np.inf
    d["b"][0, 5, :2, 3] = -np.inf
    got, want = _port(p, d, w, aggregator=agg), _ref(p, d, w,
                                                     aggregator=agg)
    for k in want:
        assert np.array_equal(np.isfinite(want[k]), np.isfinite(got[k]))
        ok = np.isfinite(want[k])
        _agree(agg, {k: np.where(ok, want[k], 0)},
               {k: np.where(ok, got[k], 0)})


@pytest.mark.parametrize("trim_frac", [0.1, 0.3, 0.45])
def test_trim_count_in_float32(trim_frac):
    """``k = min(max(1, floor(trim_frac * c)), (c - 1) // 2)`` for
    c = 3 .. 40 with ``trim_frac * c`` in float32: deltas equal to their
    rank make the trimmed mean an exact function of k."""
    cs = np.arange(3, 41)
    slots = int(cs.max())
    w = (np.arange(slots)[None, :] < cs[:, None]).astype(np.float32)[None]
    ranks = np.broadcast_to(np.arange(slots, dtype=np.float32)[::-1],
                            w.shape)
    d = {"b": (ranks * 1.0)[..., None].astype(np.float32)}
    p = {"b": np.zeros((1, len(cs), 1), np.float32)}
    kw = dict(aggregator="trimmed_mean", trim_frac=trim_frac)
    assert bitwise(_ref(p, d, w, **kw)["b"], _port(p, d, w, **kw)["b"])


def test_corrupt_scale_is_the_env_seeds_events():
    """The per-slot scale equals the reference's host engine packing:
    ``corrupt_scale`` where a filled slot's client is hit in
    ``host_fault_draws(env_seed, t).corr_u``, 1 elsewhere."""
    jf = jfaults.FaultSpec(corrupt_rate=0.4, corrupt_scale=-7.0)
    tf = FaultSpec(corrupt_rate=0.4, corrupt_scale=-7.0)
    n, m, slots, seeds, t = 50, 3, 6, (4, 9), 13
    rng = np.random.default_rng(1)
    ci = rng.integers(0, n, (len(seeds), m, slots)).astype(np.int32)
    valid = (rng.uniform(size=ci.shape) < 0.7).astype(np.float32)
    got = corrupt_scale(tf, torch.tensor(seeds), torch.full((2,), t), t_(ci),
                        t_(valid), n).numpy()
    for i, s in enumerate(seeds):
        hit = jfaults.corrupt_mask(jf, jdraws.host_fault_draws(s, t, n,
                                                               m).corr_u)
        want = np.where(hit[ci[i]] & (valid[i] > 0), np.float32(-7.0),
                        np.float32(1.0))
        assert np.array_equal(want, got[i])


def test_corruption_reaches_training_only():
    """The port's copy of the reference's
    ``tests/test_faults.py::test_corruption_changes_accuracy_not_selections``:
    corrupted deltas move the accuracy; selection, utility and
    exploration stay bitwise."""
    from repro_torch import envs, policies
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.experiment.sweep import sweep_experiments

    exp = dataclasses.replace(MNIST_CONVEX, lr=0.01)
    data = FederatedDataset.synthetic(exp.num_clients, kind="mnist", seed=0)
    spec = policies.PolicySpec.from_experiment(exp, 8, budget=8.0)
    pol = policies.make("cocs", spec, alpha=exp.holder_alpha, h_t=exp.h_t)

    def run(faults):
        return sweep_experiments({"cocs": pol},
                                 envs.make("paper", exp, faults=faults),
                                 [0], 8, eval_every=4, data=data,
                                 device="cpu")

    clean = run(None)
    bad = run(FaultSpec(corrupt_rate=0.4, corrupt_scale=-10.0))
    for f in ("selections", "utilities", "explored"):
        assert np.array_equal(getattr(clean, f)["cocs"],
                              getattr(bad, f)["cocs"]), f
    assert not np.allclose(clean.accuracy["cocs"], bad.accuracy["cocs"])


# -- through the facade ------------------------------------------------------


def _port_spec(jspec):
    return TA.ExperimentSpec.from_json(jspec.to_json())


@pytest.mark.parametrize("agg", ["mean", "trimmed_mean", "median"])
def test_robustness_panel_smoke_random(agg):
    jspec = panel_cells(ROBUSTNESS_PANEL, "Random")[(0.25, agg)]
    got = repro_torch.run(_port_spec(jspec), device="cpu")
    assert got.tier == 3 and jspec.policy.seed_offset != 0
    runs_agree(repro.run(jspec), got)


def test_tier4_all_four_faults():
    jspec = JA.ExperimentSpec(
        env=JA.EnvSpec("paper", backend="device", faults=jfaults.FaultSpec(
            dropout_rate=0.2, straggler_rate=0.3, outage_rate=0.15,
            corrupt_rate=0.25),
                       overrides=(("lr", 0.01),)),
        train=JA.TrainSpec(aggregator="clipped"),
        eval=JA.EvalSpec(eval_every=6), horizon=12, seeds=(0, 1))
    got = repro_torch.run(_port_spec(jspec), device="cpu")
    assert got.tier == 4
    runs_agree(repro.run(jspec), got)


def test_transposed_gemm_is_logreg_t():
    jspec = JA.ExperimentSpec(env=JA.EnvSpec("paper",
                                             overrides=(("lr", 0.01),)),
                              train=JA.TrainSpec(transposed_gemm=True),
                              eval=JA.EvalSpec(eval_every=6), horizon=12,
                              seeds=(0, 1))
    got = repro_torch.run(_port_spec(jspec), device="cpu")
    assert got.tier == 3
    runs_agree(repro.run(jspec), got)
    with pytest.raises(ValueError, match="logreg"):
        repro_torch.run(dataclasses.replace(
            _port_spec(jspec), train=TA.TrainSpec(model="cnn",
                                                  transposed_gemm=True)),
            device="cpu")


def test_logreg_t_deltas_are_logreg_deltas_transposed():
    """From zeros, two steps of local SGD in the transposed layout give
    the default layout's deltas transposed, within ``LOGREG_T_ATOL``."""
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.fed.batched import BatchedRoundSpec, train_slots
    from repro_torch.models.logistic import init_logreg, init_logreg_t

    data = FederatedDataset.synthetic(4, kind="mnist", seed=0).stacked()
    x = data.x[:, :8].reshape(4, 2, 4, -1)
    y = data.y[:, :8].reshape(4, 2, 4)
    out = {}
    for kind, init in (("logreg", init_logreg), ("logreg-t",
                                                 init_logreg_t)):
        spec = BatchedRoundSpec(num_edge_servers=1, steps=2, lr=0.1,
                                z_min=1, t_es=1, model=kind)
        p = {k: v.expand((4,) + v.shape) for k, v in init().items()}
        buf = torch.empty((4, 7850))
        out[kind] = train_slots(p, {"x": x, "y": y}, spec, buf)[0]
    w = out["logreg"][:, :7840].reshape(4, 784, 10)
    wt = out["logreg-t"][:, :7840].reshape(4, 10, 784)
    assert (w.transpose(1, 2) - wt).abs().max() <= LOGREG_T_ATOL
    assert (out["logreg"][:, 7840:] - out["logreg-t"][:, 7840:]).abs().max() \
        <= LOGREG_T_ATOL


def test_reference_logreg_t_params_carry_across():
    """The reference's ``logreg-t`` params after local SGD, carried
    across by ``convert.logreg_t_params_from_jax``, give its logits."""
    import jax.numpy as jnp
    from repro.fed.client import local_sgd
    from repro.models.logistic import make_loss_fn, make_model
    from repro_torch.models.convert import logreg_t_params_from_jax
    from repro_torch.models.logistic import logreg_t_logits

    params, logits_fn = make_model("logreg-t", jax.random.PRNGKey(0),
                                   input_shape=(784,))
    rng = np.random.default_rng(3)
    batches = {"x": jnp.asarray(rng.standard_normal((2, 8, 784)),
                                jnp.float32),
               "y": jnp.asarray(rng.integers(0, 10, (2, 8)))}
    delta, _ = local_sgd(params, make_loss_fn("logreg-t"), batches, 0.1)
    trained = {k: np.asarray(params[k] + delta[k]) for k in params}
    x = rng.standard_normal((5, 784)).astype(np.float32)
    got = logreg_t_logits(logreg_t_params_from_jax(trained), t_(x))
    want = np.asarray(logits_fn(trained, x))
    assert np.abs(want - got.numpy()).max() <= 1e-5
    with pytest.raises(ValueError, match="wt"):
        logreg_t_params_from_jax({"w": trained["wt"].T, "b": trained["b"]})
