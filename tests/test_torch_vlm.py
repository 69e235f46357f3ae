"""The port's VLM patch prefix (paligemma-3b's language backbone: patch
embeddings projected by ``patch_proj`` and prepended to the tokens, a
prefix-LM mask) against the reference, on the CPU, at ``reduced()`` (16
patches, MQA), float32, with the reference's own parameters converted
through ``lm_params_from_jax`` and the same numpy patches.

Tolerances, float32: logits (values of order 1-4) within 5e-5 absolute
and 1e-4 relative, as the other LMs'; greedy tokens equal, each with the
reference's top-1 leading its runner-up by more than 20 times the
largest logit gap.

The prefix-LM mask is not the flash kernel's function (and paligemma's
head dim of 256 is outside the kernel's), so the VLM's prompt attends in
plain torch: the kernel is never called.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_lm_parity import (check_greedy, embeds,  # noqa: E402
                              engine_matches_reference,
                              init_tree_matches_reference, jax_serve_flow,
                              slot_reset_matches_reference, tokens)
from _torch_parity import np_, one_torch_thread, t_  # noqa: E402,F401
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL, RTOL = 5e-5, 1e-4
ARCH = "paligemma-3b"


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.fixture(scope="module")
def model():
    jc, tc = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = JR.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          "cpu")


def _patches(cfg, b, seed):
    return embeds(b, cfg.num_patches, cfg.d_model, seed)


def test_embed_inputs_matches_reference(model):
    jc, tc, jp, tp = model
    toks, pa = tokens(jc, 2, 8, seed=1), _patches(jc, 2, 1)
    want = JT.embed_inputs(jp, jc, jnp.asarray(toks), jnp.asarray(pa))
    got = transformer.embed_inputs(tp, tc, t_(toks), t_(pa))
    assert got.shape == (2, jc.num_patches + 8, jc.d_model)
    _close(got, want)


@pytest.mark.parametrize("patches", [True, False])
def test_forward_lm_matches_reference(model, patches):
    jc, tc, jp, tp = model
    toks, pa = tokens(jc, 2, 24, seed=2), _patches(jc, 2, 2)
    want, _ = JT.forward_lm(jp, jc, jnp.asarray(toks),
                            patch_embeds=jnp.asarray(pa) if patches
                            else None)
    got, _ = transformer.forward_lm(tp, tc, t_(toks),
                                    patch_embeds=t_(pa) if patches
                                    else None)
    _close(got, want)


def test_prefix_is_bidirectional_and_never_reaches_the_kernel(
        model, monkeypatch):
    """Changing the last patch changes the first position's logits (the
    patches see each other both ways), and a VLM prefill never calls the
    flash kernel's wrapper."""
    jc, tc, jp, tp = model
    toks, pa = t_(tokens(jc, 2, 8, seed=3)), _patches(jc, 2, 3)
    pa2 = pa.copy()
    pa2[:, -1] += 1.0
    a, _ = transformer.forward_lm(tp, tc, toks, patch_embeds=t_(pa))
    b, _ = transformer.forward_lm(tp, tc, toks, patch_embeds=t_(pa2))
    assert (a[:, 0] - b[:, 0]).abs().max() > 1e-3

    def boom(*args, **kw):
        raise AssertionError("the VLM prefill called flash_attention")

    monkeypatch.setattr(L, "flash_attention", boom)
    logits, _ = R.prefill(tp, tc, {"tokens": toks, "patches": t_(pa)},
                          R.init_serve_state(tc, 2, 16, device="cpu"))
    assert logits.shape == (2, 1, tc.vocab_size)


def test_prefill_then_serve_steps_match_reference(model):
    """prefill over 16 patches + 12 tokens into a cache of 16 + 20 slots,
    then 8 serve_steps: logits and every cache field."""
    jc, tc, jp, tp = model
    toks, pa = tokens(jc, 2, 12, seed=4), _patches(jc, 2, 4)
    js = JR.init_serve_state(jc, 2, 20)
    ts = R.init_serve_state(tc, 2, 20, device="cpu")
    assert ts["k"].shape[2] == 20 + jc.num_patches
    wl, js = JR.prefill(jp, jc, {"tokens": jnp.asarray(toks),
                                 "patches": jnp.asarray(pa)}, js)
    gl, ts = R.prefill(tp, tc, {"tokens": t_(toks), "patches": t_(pa)}, ts)
    _close(gl, wl)
    step = jax.jit(lambda p, t, s: JR.serve_step(p, jc, t, s))
    nxt = tokens(jc, 2, 8, seed=5)
    for i in range(8):
        wl, js = step(jp, jnp.asarray(nxt[:, i:i + 1]), js)
        gl, ts = R.serve_step(tp, tc, t_(nxt[:, i:i + 1]), ts)
        _close(gl, wl)
    for name in js:
        np.testing.assert_allclose(np_(ts[name]).astype(np.float64),
                                   np.asarray(js[name], np.float64),
                                   atol=ATOL, rtol=RTOL)


def test_serve_flow_matches_reference(model):
    """launch/serve's flow with the same patches. Smallest top-1 lead over
    the 12 tokens: 0.0491 (largest logit gap 5.7e-6)."""
    jc, tc, jp, tp = model
    prompt, pa = tokens(jc, 2, 24, seed=6), _patches(jc, 2, 6)
    wp, wl, ws, wt = jax_serve_flow(jc, jp, jnp.asarray(prompt), 12,
                                    extra={"patches": jnp.asarray(pa)})
    res = serve.run(tc, gen_len=12, device="cpu", params=tp,
                    prompt=t_(prompt), patches=t_(pa))
    _close(res.prefill_logits, wp)
    _close(res.logits, wl)
    _close(res.step_logits, ws)
    check_greedy(res.logits[:, -1], wl[:, -1])
    check_greedy(res.step_logits, ws)
    np.testing.assert_array_equal(np_(res.tokens), np.asarray(wt))


def test_serve_command_line_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen-len", "3"]) == 0
    assert "tok/s" in capsys.readouterr().out


def test_engine_matches_reference_decoding(model):
    """The engine feeds no patches (prefill as decode, as the
    reference's)."""
    jc, tc, jp, tp = model
    engine_matches_reference(tc, tp, jc, jp, ServingEngine)


def test_slot_reset_matches_reference_without_collision(model):
    _, tc, _, tp = model
    slot_reset_matches_reference(tc, R, ServingEngine, tp, slots=3)


def test_init_params_tree_matches_reference():
    init_tree_matches_reference(jax_config(ARCH).reduced(),
                                get_config(ARCH).reduced())
