"""The port's MoE layer (``models/moe.py``) against the reference's, on
the CPU, at the ``reduced()`` size of mixtral-8x22b (4 experts, top-2,
d_model 256, d_ff_expert 256, capacity factor 1.25), float32, with the
reference's parameters converted through ``lm_params_from_jax``.

Tolerances, float32:
  * gates and the aux loss: 1e-6 absolute (float32 softmaxes and means
    summed in another order, values of order 1);
  * the block's output: 2e-6 of its largest value. The reference draws
    an expert weight of shape (E, d, f) with the fan-in E
    (``dense_init`` reads ``shape[0]``), so outputs reach ~1e3 and an
    absolute tolerance would say little; the products of 256 float32
    terms summed in another order differ by a few ulps of that;
  * model logits past the sliding window: 5e-5 absolute, as the dense
    transformer's in ``tests/test_torch_lm.py``.
Expert indices, and so the set of assignments dropped past capacity,
must be equal.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import np_, t_  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402

ARCH = "mixtral-8x22b"
GATE_TOL = 1e-6
OUT_RTOL = 2e-6
LOGIT_ATOL = 5e-5


def _cfgs(shared: int = 0):
    jc, tc = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    if shared:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, d_ff_shared=shared))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, d_ff_shared=shared))
    return jc, tc


def _moe_params(jc, seed=0):
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jc.d_model, jc.moe,
                          jnp.float32)
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(t, d, seed, positive=False):
    x = np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)
    return np.abs(x) + 0.5 if positive else x


def _force(jp, case):
    """Router weights that overflow an expert's capacity."""
    r = np.asarray(jp["router"]).copy()
    if case == "ties":
        r[:] = 0.0           # equal logits: every token picks experts 0, 1
    elif case == "one-expert":
        r[:, 0] = 0.05       # positive inputs: expert 0 first for all
    return {**jp, "router": jnp.asarray(r)}


@pytest.mark.parametrize("shared", [0, 128])
def test_route_matches_reference(shared):
    jc, tc = _cfgs(shared)
    jp, tp = _moe_params(jc)
    x = _x(96, jc.d_model, 1)
    wg, wi, wa = jax_moe.route(jp, jnp.asarray(x), jc.moe)
    before = dict(common.LAUNCHES)
    g, i, a = moe.route(tp, t_(x), tc.moe, aux=True)
    assert common.LAUNCHES == before        # the CPU takes the plain version
    np.testing.assert_array_equal(np_(i), np.asarray(wi))
    np.testing.assert_allclose(np_(g), np.asarray(wg), atol=GATE_TOL)
    np.testing.assert_allclose(float(a), float(wa), atol=GATE_TOL)
    g2, i2, none = moe.route(tp, t_(x), tc.moe)
    assert none is None and torch.equal(g2, g) and torch.equal(i2, i)


@pytest.mark.parametrize("case,shared", [("random", 0), ("random", 128),
                                         ("ties", 0), ("one-expert", 0),
                                         ("one-expert", 128)])
def test_moe_block_matches_reference(case, shared):
    """The block's output and aux; with forced overflow the assignments
    past capacity (the same ones, by the stable sort) are dropped."""
    jc, tc = _cfgs(shared)
    jp, _ = _moe_params(jc, seed=2)
    jp = _force(jp, case)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    t = 64
    x = _x(t, jc.d_model, 3, positive=case == "one-expert")
    want, wa = jax_moe.moe_block(jp, jnp.asarray(x), jc.moe)
    got, a = moe.moe_block(tp, t_(x), tc.moe, aux=True)
    want = np.asarray(want)
    np.testing.assert_allclose(np_(got), want, rtol=0,
                               atol=OUT_RTOL * np.abs(want).max())
    np.testing.assert_allclose(float(a), float(wa), atol=GATE_TOL)
    _, none = moe.moe_block(tp, t_(x), tc.moe)
    assert none is None
    cap = jax_moe._capacity(t, jc.moe)
    assert moe._capacity(t, tc.moe) == cap == 48
    _, idx, _ = jax_moe.route(jp, jnp.asarray(x), jc.moe)
    load = np.bincount(np.asarray(idx).ravel(), minlength=jc.moe.num_experts)
    if case == "random":
        assert load.max() <= cap
    else:
        assert load[0] == t > cap           # 16 assignments dropped
    if case == "ties" and not shared:
        # tokens 48-63 lost both experts: nothing is added to them
        assert not np.abs(np_(got)[48:]).any()
        assert np.abs(np_(got)[:48]).max(axis=1).all()


def test_moe_block_keeps_the_model_dtype():
    jc, tc = _cfgs()
    _, tp = _moe_params(jc)
    bf = {k: (v if k == "router" else v.to(torch.bfloat16))
          for k, v in tp.items()}
    y, _ = moe.moe_block(bf, t_(_x(16, jc.d_model, 4)).to(torch.bfloat16),
                         tc.moe)
    assert y.dtype == torch.bfloat16 and y.shape == (16, jc.d_model)
    assert torch.isfinite(y.float()).all()


def test_prefill_past_the_window_then_steps_match_reference():
    """A 96-token prompt against the reduced window of 64: the prefill's
    attention (the flash path) and the 8 decode steps after it both mask
    by the window."""
    jc, tc = _cfgs()
    assert jc.sliding_window == 64
    jp = JR.init_params(jc, jax.random.PRNGKey(1))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jc.vocab_size, (2, 96)).astype(np.int32)
    js = JR.init_serve_state(jc, 2, 104)
    ts = R.init_serve_state(tc, 2, 104, device="cpu")
    wl, js = JR.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, js)
    gl, ts = R.prefill(tp, tc, {"tokens": t_(toks)}, ts)
    np.testing.assert_allclose(np_(gl), np.asarray(wl), atol=LOGIT_ATOL,
                               rtol=1e-4)
    # the window bites: the same prompt without it gives other logits
    full = dataclasses.replace(jc, sliding_window=0)
    nl, _ = JR.prefill(jp, full, {"tokens": jnp.asarray(toks)},
                       JR.init_serve_state(full, 2, 104))
    assert np.abs(np.asarray(nl) - np.asarray(wl)).max() > 100 * LOGIT_ATOL
    nxt = rng.integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
    for i in range(8):
        wl, js = JR.serve_step(jp, jc, jnp.asarray(nxt[:, i:i + 1]), js)
        gl, ts = R.serve_step(tp, tc, t_(nxt[:, i:i + 1]), ts)
        np.testing.assert_allclose(np_(gl), np.asarray(wl), atol=LOGIT_ATOL,
                                   rtol=1e-4)
    for name in js:
        np.testing.assert_allclose(np_(ts[name]).astype(np.float64),
                                   np.asarray(js[name], np.float64),
                                   atol=LOGIT_ATOL, rtol=1e-4)


def test_serve_command_line_runs_mixtral_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "96", "--gen-len", "3"]) == 0
    out = capsys.readouterr().out
    assert "prefill(96 tokens)" in out and "tok/s" in out
