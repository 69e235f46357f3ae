"""The port's encoder-decoder (the SeamlessM4T backbone) against the
reference, on the CPU, at ``reduced()`` (2 encoder and 2 decoder layers,
16 frames), float32, with the reference's own parameters converted
through ``lm_params_from_jax`` and the same numpy frames.

Tolerances, float32: encoder outputs and logits (values of order 1-4)
within 5e-5 absolute and 1e-4 relative, as the other LMs'; greedy tokens
equal, each with the reference's top-1 leading its runner-up by more
than 20 times the largest logit gap.

The encoder is bidirectional: the reference asks for it with
``mask=None`` (``layers.py:128``); the port with ``causal=False`` to the
flash kernel. R13: the reference's prefill leaves the decoder's
self-attention cache empty and ``pos`` at 0; the port reproduces that and
logs it.
"""
import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_lm_parity import (check_greedy, embeds,  # noqa: E402
                              engine_matches_reference,
                              init_tree_matches_reference, jax_serve_flow,
                              slot_reset_matches_reference, tokens)
from _torch_parity import np_, one_torch_thread, t_  # noqa: E402,F401
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL, RTOL = 5e-5, 1e-4
ARCH = "seamless-m4t-large-v2"


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.fixture(scope="module")
def model():
    jc, tc = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = JR.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          "cpu")


def _frames(cfg, b, seed):
    return embeds(b, cfg.num_frames, cfg.d_model, seed)


def test_encode_matches_reference(model):
    jc, tc, jp, tp = model
    fr = _frames(jc, 2, 1)
    _close(encdec.encode(tp, tc, t_(fr)), JE.encode(jp, jc, jnp.asarray(fr)))


def test_encoder_is_bidirectional(model, monkeypatch):
    """Changing the last frame changes the encoder's output at the first
    position (it would not if the encoder were causal), on the port as on
    the reference; and the encoder asks the flash kernel for causal=False,
    the decoder for causal=True."""
    jc, tc, jp, tp = model
    fr = _frames(jc, 2, 2)
    fr2 = fr.copy()
    fr2[:, -1] += 1.0
    for enc, p, cfg, a in ((encdec.encode, tp, tc, t_),
                           (JE.encode, jp, jc, jnp.asarray)):
        first = np_(enc(p, cfg, a(fr)))[:, 0]
        moved = np_(enc(p, cfg, a(fr2)))[:, 0]
        assert np.abs(first - moved).max() > 1e-3
    calls = []
    real = L.flash_attention

    def spy(q, k, v, causal=True, window=0):
        calls.append(causal)
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(L, "flash_attention", spy)
    encdec.forward(tp, tc, t_(fr), t_(tokens(jc, 2, 8, seed=3)))
    assert calls == [False] * tc.encoder_layers + [True] * tc.num_layers


@pytest.mark.parametrize("s", [8, 24])
def test_forward_matches_reference(model, s):
    jc, tc, jp, tp = model
    fr, toks = _frames(jc, 2, 4), tokens(jc, 2, s, seed=s)
    want, _ = JE.forward(jp, jc, jnp.asarray(fr), jnp.asarray(toks))
    got, aux = encdec.forward(tp, tc, t_(fr), t_(toks))
    assert float(aux) == 0.0
    _close(got, want)


def test_prefill_then_serve_steps_match_reference(model):
    """prefill (one encode), then 8 serve_steps: logits and every cache
    field, enc_out included."""
    jc, tc, jp, tp = model
    fr, toks = _frames(jc, 2, 5), tokens(jc, 2, 12, seed=5)
    js = JR.init_serve_state(jc, 2, 20)
    ts = R.init_serve_state(tc, 2, 20, device="cpu")
    wl, js = JR.prefill(jp, jc, {"tokens": jnp.asarray(toks),
                                 "frames": jnp.asarray(fr)}, js)
    gl, ts = R.prefill(tp, tc, {"tokens": t_(toks), "frames": t_(fr)}, ts)
    assert gl.shape == (2, 1, jc.vocab_size)
    _close(gl, wl)
    step = jax.jit(lambda p, t, s: JR.serve_step(p, jc, t, s))
    nxt = tokens(jc, 2, 8, seed=6)
    for i in range(8):
        wl, js = step(jp, jnp.asarray(nxt[:, i:i + 1]), js)
        gl, ts = R.serve_step(tp, tc, t_(nxt[:, i:i + 1]), ts)
        _close(gl, wl)
    assert set(ts) == set(js)
    for name in js:
        np.testing.assert_allclose(np_(ts[name]).astype(np.float64),
                                   np.asarray(js[name], np.float64),
                                   atol=ATOL, rtol=RTOL)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_r13_prefill_leaves_the_decoder_cache_empty(model):
    """R13, reproduced: after a prefill of 8 tokens ``pos`` is 0, no
    ``kpos`` slot is >= 0 and ``k``/``v`` are zero, on the reference and
    on the port; only ``enc_out`` is written. The port logs it."""
    jc, tc, jp, tp = model
    fr, toks = _frames(jc, 2, 7), tokens(jc, 2, 8, seed=7)
    _, js = JR.prefill(jp, jc, {"tokens": jnp.asarray(toks),
                                "frames": jnp.asarray(fr)},
                       JR.init_serve_state(jc, 2, 16))
    # a handler on the registry's own logger: the port's log setup may
    # have stopped "repro_torch" from propagating to the root
    seen = _Records()
    R.log.addHandler(seen)
    try:
        _, ts = R.prefill(tp, tc, {"tokens": t_(toks), "frames": t_(fr)},
                          R.init_serve_state(tc, 2, 16, device="cpu"))
    finally:
        R.log.removeHandler(seen)
    assert any("R13" in m for m in seen.messages)
    for st, a in ((js, np.asarray), (ts, np_)):
        assert (a(st["pos"]) == 0).all()
        assert (a(st["kpos"]) < 0).all()
        assert not a(st["k"]).any() and not a(st["v"]).any()
        assert a(st["enc_out"]).any()


def test_serve_flow_matches_reference(model):
    """launch/serve's flow with the same frames: prefill, greedy decode
    from position 0 (R13). Smallest top-1 lead over the 12 tokens:
    0.00236 (largest logit gap 5.5e-6)."""
    jc, tc, jp, tp = model
    prompt, fr = tokens(jc, 2, 16, seed=8), _frames(jc, 2, 8)
    wp, wl, ws, wt = jax_serve_flow(jc, jp, jnp.asarray(prompt), 12,
                                    extra={"frames": jnp.asarray(fr)})
    res = serve.run(tc, gen_len=12, device="cpu", params=tp,
                    prompt=t_(prompt), frames=t_(fr))
    _close(res.prefill_logits, wp)
    _close(res.logits, wl)
    _close(res.step_logits, ws)
    check_greedy(res.logits[:, -1], wl[:, -1])
    check_greedy(res.step_logits, ws)
    np.testing.assert_array_equal(np_(res.tokens), np.asarray(wt))


def test_launcher_draws_frames_from_the_seed():
    cfg = get_config(ARCH).reduced()
    params = R.init_params(cfg, 0, device="cpu")
    a = serve.run(cfg, batch=2, prompt_len=8, gen_len=2, seed=3,
                  device="cpu", params=params)
    b = serve.run(cfg, batch=2, prompt_len=8, gen_len=2, seed=3,
                  device="cpu", params=params)
    c = serve.run(cfg, batch=2, prompt_len=8, gen_len=2, seed=4,
                  device="cpu", params=params)
    assert torch.equal(a.prefill_logits, b.prefill_logits)
    assert not torch.equal(a.prefill_logits, c.prefill_logits)


def test_serve_command_line_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen-len", "3"]) == 0
    assert "tok/s" in capsys.readouterr().out


def test_engine_matches_reference_decoding(model):
    """The engine never encodes (prefill as decode, as the reference's):
    cross-attention reads the zero ``enc_out`` of a fresh state."""
    jc, tc, jp, tp = model
    engine_matches_reference(tc, tp, jc, jp, ServingEngine)


def test_slot_reset_matches_reference_without_collision(model):
    _, tc, _, tp = model
    assert R.state_batch_axes(tc) == {"k": 1, "v": 1, "kpos": 0, "pos": 0,
                                      "enc_out": 0}
    slot_reset_matches_reference(tc, R, ServingEngine, tp, slots=3)


def test_init_params_tree_matches_reference():
    init_tree_matches_reference(jax_config(ARCH).reduced(),
                                get_config(ARCH).reduced())
