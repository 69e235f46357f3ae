"""The port's LM serving slice against the reference, on the CPU, at the
``reduced()`` size of qwen2-1.5b (dense GQA transformer), mixtral-8x22b
(MoE transformer, sliding window) and rwkv6-1.6b (attention-free),
float32, with the reference's own parameters converted through
``lm_params_from_jax``.

Tolerances, float32:
  * building blocks: 1e-6 absolute and relative (the same float32
    operations, sums in another order);
  * logits of the whole model (values of order 1-4): 5e-5 absolute for
    the transformers, dense and MoE (the MoE layers route the same
    experts, so their sums differ in order only, as the MLP's do; the
    largest gap measured on these tests is 8.2e-6); 2e-4 for RWKV6, whose reference prefill runs the
    chunked recurrence (exp(+-cumsum log_w) within a chunk, the reference
    kernel test's 2e-4) against the port's sequential one;
  * greedy tokens: equal. Each comparison first checks that the
    reference's top-1 logit leads its runner-up by more than 20 times
    the largest logit gap between the two packages, so that an equal
    token is a consequence of the logit agreement and not luck; on the
    seeds used the smallest lead is stated beside each test.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_lm_parity import check_greedy as _check_greedy  # noqa: E402
from _torch_lm_parity import init_tree_matches_reference  # noqa: E402
from _torch_lm_parity import jax_serve_flow as _jax_serve_flow  # noqa: E402
from _torch_lm_parity import random_state as _random_state  # noqa: E402
from _torch_lm_parity import \
    reference_decode_alone as _reference_decode_alone  # noqa: E402
from _torch_lm_parity import reference_reset as _reference_reset  # noqa: E402
from _torch_parity import np_, one_torch_thread, t_  # noqa: E402,F401
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import rwkv6 as jax_rwkv6  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import rwkv6, transformer  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("qwen2-1.5b", "mixtral-8x22b", "rwkv6-1.6b")
BLOCK_TOL = 1e-6
LOGIT_ATOL = {"dense": 5e-5, "moe": 5e-5, "ssm": 2e-4}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jax cfg, port cfg, jax params, port params) of one reduced arch."""
    jc = jax_config(request.param).reduced()
    tc = get_config(request.param).reduced()
    jp = JR.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, lm_params_from_jax(_np_tree(jp), "cpu")


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_logits(got, want, cfg):
    np.testing.assert_allclose(np_(got), np.asarray(want),
                               atol=LOGIT_ATOL[cfg.arch_type], rtol=1e-4)


# ---------------------------------------------------------------------------
# configs, converter, entry points


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(arch, reduced):
    jc, tc = jax_config(arch), get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.torch_dtype == getattr(torch, jc.dtype)


def test_unported_arch_raises_naming_the_ported():
    """Every id of the reference resolves; an unknown id raises KeyError
    naming the available ones."""
    with pytest.raises(KeyError, match="qwen2-1.5b"):
        get_config("no-such-arch-1b")
    with pytest.raises(KeyError, match="zamba2-1.2b"):
        get_config("no-such-arch-1b")


def test_unported_arch_types_raise():
    """An unknown arch type raises; the VLM patch prefix is served (no
    NotImplementedError any more)."""
    odd = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              arch_type="diffusion")
    with pytest.raises(ValueError, match="unknown arch type"):
        R.init_params(odd, 0, device="cpu")
    with pytest.raises(ValueError, match="unknown arch type"):
        R.init_serve_state(odd, 1, 8, device="cpu")
    vlm = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              num_patches=16)
    params = transformer.init_lm(vlm, torch.Generator().manual_seed(0))
    assert params["patch_proj"].shape == (vlm.d_model, vlm.d_model)


def test_entry_points_ask_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    cfg = get_config("qwen2-1.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.init_serve_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(cfg, batch=1, prompt_len=4, gen_len=2)


def test_converter_keeps_bfloat16_bits():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                    jnp.bfloat16)
    tree = {"a": {"w": np.asarray(x)}, "pos": np.arange(3, dtype=np.int32)}
    got = lm_params_from_jax(tree, "cpu")
    assert got["a"]["w"].dtype == torch.bfloat16
    assert got["pos"].dtype == torch.int32
    np.testing.assert_array_equal(got["a"]["w"].float().numpy(),
                                  np.asarray(x, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """Same keys, shapes and dtypes as the reference's init (the numbers
    differ: torch's generator, JAX's scales)."""
    init_tree_matches_reference(jax_config(arch).reduced(),
                                get_config(arch).reduced())


# ---------------------------------------------------------------------------
# building blocks


def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    w = rng.standard_normal((256,)).astype(np.float32) * 0.1
    b = rng.standard_normal((256,)).astype(np.float32) * 0.1
    flat = x.reshape(2, 5, 256)
    checks = [
        (L.rms_norm(t_(flat), t_(w)), JL.rms_norm(flat, w)),
        (L.group_norm_heads(t_(flat), t_(w), t_(b), 4),
         JL.group_norm_heads(flat, w, b, 4)),
        (L.rope_freqs(64, 1e4), JL.rope_freqs(64, 1e4)),
    ]
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    checks.append((L.apply_rope(t_(x), t_(pos), 1e4),
                   JL.apply_rope(x, pos, 1e4)))
    for got, want in checks:
        np.testing.assert_allclose(np_(got), np.asarray(want),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL)


@pytest.mark.parametrize("kind", ["1d", "ring", "window", "prefix"])
def test_attention_mask_matches_reference(kind):
    q = np.arange(6, dtype=np.int32)
    k = np.arange(8, dtype=np.int32)
    kw = {}
    if kind == "ring":
        q = np.array([[5], [3]], np.int32)
        k = np.array([[0, 1, 2, 3, 4, 5, -1, -1], [8, 1, 2, 3, -1, -1, -1,
                                                    -1]], np.int32)
        kw["k_valid"] = k >= 0
    elif kind == "window":
        kw["sliding_window"] = 3
    elif kind == "prefix":
        kw["prefix_len"] = 2
    want = JL.attention_scores_mask(jnp.asarray(q), jnp.asarray(k),
                                    **{a: jnp.asarray(v) if a == "k_valid"
                                       else v for a, v in kw.items()})
    got = L.attention_scores_mask(t_(q), t_(k),
                                  **{a: t_(v) if a == "k_valid" else v
                                     for a, v in kw.items()})
    np.testing.assert_array_equal(np_(got), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_dims", [2, 3])
def test_gqa_attention_matches_reference(dtype, mask_dims):
    rng = np.random.default_rng(mask_dims)
    q = rng.standard_normal((2, 3, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 64)).astype(np.float32)
    if mask_dims == 2:
        mask = JL.attention_scores_mask(jnp.arange(4, 7), jnp.arange(7))
    else:
        mask = JL.attention_scores_mask(jnp.asarray([[5], [2]]),
                                        jnp.arange(7)[None].repeat(2, 0))
    jd = jnp.dtype(dtype)
    want = JL.gqa_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), mask)
    td = getattr(torch, dtype)
    got = L.gqa_attention(*(t_(a, td) for a in (q, k, v)),
                          t_(np.asarray(mask)))
    # bfloat16: both round the float32 result once; the float32 sums
    # differ in order, which moves a rounding at most one bf16 ulp
    tol = BLOCK_TOL if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(np_(got.float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# whole models


def test_forward_lm_matches_reference(model):
    jc, tc, jp, tp = model
    toks = _tokens(jc, 2, 64, seed=1)
    mod = jax_rwkv6 if jc.arch_type == "ssm" else jax_tf
    want, want_aux = mod.forward_lm(jp, jc, jnp.asarray(toks))
    got, aux = (rwkv6 if tc.arch_type == "ssm" else transformer).forward_lm(
        tp, tc, t_(toks))
    if tc.moe is None:
        assert float(aux) == 0.0
    else:      # the layers' load-balance losses, summed (~1 a layer)
        assert float(want_aux) > 1.0
        np.testing.assert_allclose(float(aux), float(want_aux),
                                   atol=BLOCK_TOL * tc.num_layers)
    _assert_logits(got, want, jc)


def test_prefill_then_serve_steps_match_reference(model):
    """prefill, then 8 serve_steps from its state (the transformer's cache,
    RWKV6's state as the reference's prefill leaves it: unchanged)."""
    jc, tc, jp, tp = model
    toks = _tokens(jc, 2, 64, seed=2)
    js = JR.init_serve_state(jc, 2, 72)
    ts = R.init_serve_state(tc, 2, 72, device="cpu")
    wl, js = JR.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, js)
    gl, ts = R.prefill(tp, tc, {"tokens": t_(toks)}, ts)
    assert gl.shape == (2, 1, jc.vocab_size)
    _assert_logits(gl, wl, jc)
    nxt = _tokens(jc, 2, 8, seed=3)
    for i in range(8):
        wl, js = JR.serve_step(jp, jc, jnp.asarray(nxt[:, i:i + 1]), js)
        gl, ts = R.serve_step(tp, tc, t_(nxt[:, i:i + 1]), ts)
        _assert_logits(gl, wl, jc)
    for name in js:
        np.testing.assert_allclose(np_(ts[name]).astype(np.float64),
                                   np.asarray(js[name], np.float64),
                                   atol=LOGIT_ATOL[jc.arch_type], rtol=1e-4)


def test_rwkv6_prefill_agrees_with_token_rebuild():
    """The WKV scan's form (prefill) and linear_recurrence_step's form
    (token by token) of one function: the last position's logits agree."""
    cfg = get_config("rwkv6-1.6b").reduced()
    params = R.init_params(cfg, 1, device="cpu")
    toks = t_(_tokens(cfg, 2, 64, seed=4))
    pl, _ = R.prefill(params, cfg, {"tokens": toks},
                      R.init_serve_state(cfg, 2, 64, device="cpu"))
    state = R.init_serve_state(cfg, 2, 64, device="cpu")
    for i in range(64):
        sl, state = R.serve_step(params, cfg, toks[:, i:i + 1], state)
    np.testing.assert_allclose(np_(pl), np_(sl), atol=1e-4, rtol=1e-4)


def test_serve_flow_matches_reference(model):
    """launch/serve's flow, greedy. Smallest top-1 lead on prompt seed 5
    over the 12 tokens: 0.446 (qwen2 reduced, largest logit gap 1.3e-6),
    0.0064 (mixtral reduced, gap 8.2e-6),
    0.0083 (rwkv6 reduced, gap 1.2e-5)."""
    jc, tc, jp, tp = model
    prompt = _tokens(jc, 2, 64, seed=5)
    wp, wl, ws, wt = _jax_serve_flow(jc, jp, jnp.asarray(prompt), 12)
    before = dict(common.LAUNCHES)
    res = serve.run(tc, gen_len=12, device="cpu", params=tp,
                    prompt=t_(prompt))
    assert common.LAUNCHES == before
    _assert_logits(res.prefill_logits, wp, jc)
    _assert_logits(res.logits, wl, jc)
    _assert_logits(res.step_logits, ws, jc)
    _check_greedy(res.logits[:, -1], wl[:, -1])
    _check_greedy(res.step_logits, ws)
    np.testing.assert_array_equal(np_(res.tokens), np.asarray(wt))
    assert res.decode_tok_per_s > 0 and res.prefill_s > 0


def test_serve_command_line_runs_on_cpu(capsys):
    assert serve.main(["--arch", "rwkv6-1.6b", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "64",
                       "--gen-len", "3"]) == 0
    out = capsys.readouterr().out
    assert "prefill(64 tokens)" in out and "tok/s" in out


# ---------------------------------------------------------------------------
# serving engine (held against the reference's registry: see
# ``_torch_lm_parity``)


def test_engine_matches_reference_decoding(model):
    """3 slots, 5 requests of 2-7 prompt tokens: slots are refilled and
    reset; every request's tokens equal the reference's decoding of it."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jc.vocab_size, n).tolist()
               for n in (3, 7, 2, 5, 4)]
    engine = ServingEngine(tc, tp, batch_slots=3, max_len=16)
    reqs = [engine.submit(p, max_tokens=4) for p in prompts]
    finished = engine.run()
    assert sorted(r.uid for r in finished) == [1, 2, 3, 4, 5]
    for req, prompt in zip(reqs, prompts):
        assert req.done and len(req.output) == 4
        assert req.output == _reference_decode_alone(jc, jp, prompt, 4, 16)
    assert engine.stats["tokens_out"] == 20


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_reset_matches_reference_without_collision(arch):
    """R6: at a slot count that no other state axis has (3), resetting
    slot i is the reference's rule, and only slot i's lanes change."""
    tc = get_config(arch).reduced()
    engine = ServingEngine(tc, R.init_params(tc, 0, device="cpu"),
                           batch_slots=3, max_len=16)
    start = _random_state(engine.state, seed=7)
    engine.state = lm_params_from_jax(start, "cpu")
    engine._reset_slot_state(1)
    fresh = R.init_serve_state(tc, 3, 16, device="cpu")
    want = _reference_reset(start, fresh, 3, 1)
    for k in start:
        np.testing.assert_array_equal(np_(engine.state[k]), want[k])
    axes = R.state_batch_axes(tc)
    for k in start:
        lanes = np.moveaxis(np_(engine.state[k]), axes[k], 0)
        np.testing.assert_array_equal(
            lanes[1], np.moveaxis(np_(fresh[k]), axes[k], 0)[1])
        np.testing.assert_array_equal(
            lanes[[0, 2]], np.moveaxis(start[k], axes[k], 0)[[0, 2]])


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_reset_uses_the_batch_axis_when_counts_collide(arch):
    """R6: with as many slots as layers (2 at the reduced size) the
    reference's rule zeroes layer i of every slot; the port zeroes slot i
    of every layer and leaves the other slot as it was."""
    tc = get_config(arch).reduced()
    assert tc.num_layers == 2
    engine = ServingEngine(tc, R.init_params(tc, 0, device="cpu"),
                           batch_slots=2, max_len=16)
    start = _random_state(engine.state, seed=8)
    engine.state = lm_params_from_jax(start, "cpu")
    engine._reset_slot_state(1)
    fresh = R.init_serve_state(tc, 2, 16, device="cpu")
    layered = "wkv" if tc.arch_type == "ssm" else "k"
    got = np_(engine.state[layered])
    np.testing.assert_array_equal(got[:, 1], np_(fresh[layered])[:, 1])
    np.testing.assert_array_equal(got[:, 0], start[layered][:, 0])
    ref = _reference_reset(start, fresh, 2, 1)[layered]
    np.testing.assert_array_equal(ref[1], np_(fresh[layered])[1])
    assert not np.array_equal(got, ref)
