"""The port's zamba2 (Mamba2 backbone and one shared attention block)
against the reference, on the CPU, at ``reduced()`` (2 Mamba2 layers in
one group, one shared-attention site, chunks of 32), float32, with the
reference's own parameters converted through ``lm_params_from_jax``.

Tolerances, float32: logits (values of order 1-4) within 5e-5 absolute
and 1e-4 relative, as the other LMs' (the chunked SSD form sums in
another order than the reference's; the largest gap measured here is
stated beside each test); serve states within the same; greedy tokens
equal, each with the reference's top-1 leading its runner-up by more
than 20 times the largest logit gap.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_lm_parity import (check_greedy, engine_matches_reference,  # noqa: E402
                              init_tree_matches_reference, jax_serve_flow,
                              slot_reset_matches_reference, tokens)
from _torch_parity import np_, one_torch_thread, t_  # noqa: E402,F401
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import zamba2 as JZ  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import zamba2  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL, RTOL = 5e-5, 1e-4
ARCH = "zamba2-1.2b"


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.fixture(scope="module")
def model():
    jc, tc = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = JR.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          "cpu")


def test_group_sizes_match_reference():
    for reduced in (False, True):
        jc, tc = jax_config(ARCH), get_config(ARCH)
        if reduced:
            jc, tc = jc.reduced(), tc.reduced()
        assert zamba2._group_sizes(tc) == JZ._group_sizes(jc)
    assert zamba2._group_sizes(get_config(ARCH)) == [6] * 6 + [2]


@pytest.mark.parametrize("t", [32, 64, 96])
def test_forward_lm_matches_reference(model, t):
    jc, tc, jp, tp = model
    toks = tokens(jc, 2, t, seed=t)
    want, _ = JZ.forward_lm(jp, jc, jnp.asarray(toks))
    got, aux = zamba2.forward_lm(tp, tc, t_(toks))
    assert float(aux) == 0.0
    _close(got, want)


def test_prefill_then_serve_steps_match_reference(model):
    """prefill (the forward; the state comes back unchanged, as the
    reference's), then 8 serve_steps from that state, logits and state."""
    jc, tc, jp, tp = model
    toks = tokens(jc, 2, 64, seed=2)
    js = JR.init_serve_state(jc, 2, 72)
    ts = R.init_serve_state(tc, 2, 72, device="cpu")
    wl, js = JR.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, js)
    gl, ts = R.prefill(tp, tc, {"tokens": t_(toks)}, ts)
    assert gl.shape == (2, 1, jc.vocab_size)
    _close(gl, wl)
    assert int(ts["pos"].abs().sum()) == 0 and not ts["ssm"].any()
    nxt = tokens(jc, 2, 8, seed=3)
    step = jax.jit(lambda p, t, s: JR.serve_step(p, jc, t, s))
    for i in range(8):
        wl, js = step(jp, jnp.asarray(nxt[:, i:i + 1]), js)
        gl, ts = R.serve_step(tp, tc, t_(nxt[:, i:i + 1]), ts)
        _close(gl, wl)
    assert set(ts) == set(js)
    for name in js:
        np.testing.assert_allclose(np_(ts[name]).astype(np.float64),
                                   np.asarray(js[name], np.float64),
                                   atol=ATOL, rtol=RTOL)


def test_window_decode_matches_reference(model):
    """Decode over a ring buffer of 8 slots (window 8): 12 steps wrap it."""
    jc, tc, jp, tp = model
    js = JR.init_serve_state(jc, 2, 16, window=8)
    ts = R.init_serve_state(tc, 2, 16, window=8, device="cpu")
    assert ts["k"].shape == js["k"].shape
    nxt = tokens(jc, 2, 12, seed=4)
    step = jax.jit(lambda p, t, s: JR.serve_step(p, jc, t, s, window=8))
    for i in range(12):
        wl, js = step(jp, jnp.asarray(nxt[:, i:i + 1]), js)
        gl, ts = R.serve_step(tp, tc, t_(nxt[:, i:i + 1]), ts, window=8)
        _close(gl, wl)


def test_prefill_agrees_with_token_rebuild(model):
    """The chunked form (prefill) and the step form (token by token) of one
    function: the last position's logits agree."""
    _, tc, _, tp = model
    toks = t_(tokens(tc, 2, 80, seed=5))
    pl, _ = R.prefill(tp, tc, {"tokens": toks},
                      R.init_serve_state(tc, 2, 80, device="cpu"))
    state = R.init_serve_state(tc, 2, 80, device="cpu")
    for i in range(80):
        sl, state = R.serve_step(tp, tc, toks[:, i:i + 1], state)
    np.testing.assert_allclose(np_(pl), np_(sl), atol=1e-4, rtol=1e-4)


def test_r12_chunk_of_128_stays_finite(model):
    """R12 at the model level: with zamba2's own chunk of 128 at the
    reduced width, the reference's forward over 128 tokens is not finite;
    the port's is, and equals its token-by-token rebuild."""
    jc, tc, jp, tp = model
    jc = dataclasses.replace(jc, ssm=dataclasses.replace(jc.ssm,
                                                         chunk_size=128))
    tc = dataclasses.replace(tc, ssm=dataclasses.replace(tc.ssm,
                                                         chunk_size=128))
    toks = tokens(jc, 2, 128, seed=6)
    want, _ = JZ.forward_lm(jp, jc, jnp.asarray(toks))
    assert not np.isfinite(np.asarray(want)).all()
    got, _ = zamba2.forward_lm(tp, tc, t_(toks))
    assert torch.isfinite(got).all()
    state = R.init_serve_state(tc, 2, 128, device="cpu")
    for i in range(128):
        sl, state = R.serve_step(tp, tc, t_(toks[:, i:i + 1]), state)
    np.testing.assert_allclose(np_(got[:, -1]), np_(sl[:, -1]), atol=1e-4,
                               rtol=1e-4)


def test_serve_flow_matches_reference(model):
    """launch/serve's flow: prefill, the token-by-token rebuild of the
    state (hybrid, as ssm), greedy decode. Smallest top-1 lead on prompt
    seed 7 over the 12 tokens: 0.0202 (largest logit gap 4.3e-6)."""
    jc, tc, jp, tp = model
    prompt = tokens(jc, 2, 64, seed=7)
    wp, wl, ws, wt = jax_serve_flow(jc, jp, jnp.asarray(prompt), 12,
                                    jit_rebuild=True)
    before = dict(common.LAUNCHES)
    res = serve.run(tc, gen_len=12, device="cpu", params=tp,
                    prompt=t_(prompt))
    assert common.LAUNCHES == before
    _close(res.prefill_logits, wp)
    _close(res.logits, wl)
    _close(res.step_logits, ws)
    check_greedy(res.logits[:, -1], wl[:, -1])
    check_greedy(res.step_logits, ws)
    np.testing.assert_array_equal(np_(res.tokens), np.asarray(wt))
    assert res.rebuild_s > 0


def test_serve_command_line_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "32", "--gen-len", "3"]) == 0
    out = capsys.readouterr().out
    assert "prefill(32 tokens)" in out and "tok/s" in out


def test_engine_matches_reference_decoding(model):
    jc, tc, jp, tp = model
    engine_matches_reference(tc, tp, jc, jp, ServingEngine)


def test_slot_reset_matches_reference_without_collision(model):
    _, tc, _, tp = model
    assert R.state_batch_axes(tc) == {"ssm": 1, "conv": 1, "k": 1, "v": 1,
                                      "kpos": 0, "pos": 0}
    slot_reset_matches_reference(tc, R, ServingEngine, tp, slots=3)


def test_init_params_tree_matches_reference():
    init_tree_matches_reference(jax_config(ARCH).reduced(),
                                get_config(ARCH).reduced())
