"""The rest of the LM zoo in the port against the reference, on the CPU:
the seven configs added beside qwen2-1.5b, rwkv6-1.6b and mixtral-8x22b,
field by field; granite-8b, granite-20b (MQA), qwen2.5-14b (QKV bias)
and kimi-k2 (MoE, also at E = 16 and k = 8, since ``reduced()`` caps k
at 2) at ``reduced()``, float32, with the reference's own parameters
(``lm_params_from_jax``); the MoE combine's pinned order for k > 2; the
parameter converter on every new tree in bf16; the shape specs; and the
sliced draws of large parameters.

Tolerances, float32: logits (values of order 1-4) within 5e-5 absolute
and 1e-4 relative, as the other LMs'; ``moe_block`` at E = 16, k = 8
within 1e-6 of the output's largest value (~2.4; the same gates and the
same combine order, the experts' float32 products summed in another
order); greedy tokens equal, each with the reference's top-1
leading its runner-up by more than 20 times the largest logit gap. The
combine in bf16: bitwise.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_lm_parity import check_greedy, jax_serve_flow, tokens  # noqa: E402
from _torch_parity import np_, one_torch_thread, t_  # noqa: E402,F401
from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NEW = ("granite-8b", "granite-20b", "qwen2.5-14b", "kimi-k2-1t-a32b",
       "zamba2-1.2b", "paligemma-3b", "seamless-m4t-large-v2")
TRANSFORMERS = ("granite-8b", "granite-20b", "qwen2.5-14b",
                "kimi-k2-1t-a32b", "kimi-k2-e16-k8")
ATOL, RTOL = 5e-5, 1e-4
MOE_TOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _e16_k8(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=16, top_k=8))


def _configs(arch):
    """(reference cfg, port cfg) at reduced(); "kimi-k2-e16-k8" is kimi's
    reduced() with 16 experts and top-8."""
    if arch == "kimi-k2-e16-k8":
        jc, tc = _configs("kimi-k2-1t-a32b")
        return _e16_k8(jc), _e16_k8(tc)
    return jax_config(arch).reduced(), get_config(arch).reduced()


@pytest.fixture(scope="module", params=TRANSFORMERS)
def model(request):
    jc, tc = _configs(request.param)
    jp = JR.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          "cpu")


# ---------------------------------------------------------------------------
# configs


def test_arch_ids_are_the_references_in_its_order():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(arch, reduced):
    jc, tc = jax_config(arch), get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.torch_dtype == getattr(torch, jc.dtype)


# ---------------------------------------------------------------------------
# the new transformer configs at reduced()


def test_forward_lm_matches_reference(model):
    jc, tc, jp, tp = model
    toks = tokens(jc, 2, 32, seed=1)
    want, want_aux = JT.forward_lm(jp, jc, jnp.asarray(toks))
    got, aux = transformer.forward_lm(tp, tc, t_(toks))
    if tc.moe is not None:
        np.testing.assert_allclose(float(aux), float(want_aux),
                                   atol=1e-6 * tc.num_layers)
    _close(got, want)


def test_prefill_then_serve_steps_match_reference(model):
    jc, tc, jp, tp = model
    toks = tokens(jc, 2, 24, seed=2)
    js = JR.init_serve_state(jc, 2, 32)
    ts = R.init_serve_state(tc, 2, 32, device="cpu")
    wl, js = JR.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, js)
    gl, ts = R.prefill(tp, tc, {"tokens": t_(toks)}, ts)
    _close(gl, wl)
    step = jax.jit(lambda p, t, s: JR.serve_step(p, jc, t, s))
    nxt = tokens(jc, 2, 8, seed=3)
    for i in range(8):
        wl, js = step(jp, jnp.asarray(nxt[:, i:i + 1]), js)
        gl, ts = R.serve_step(tp, tc, t_(nxt[:, i:i + 1]), ts)
        _close(gl, wl)
    for name in js:
        np.testing.assert_allclose(np_(ts[name]).astype(np.float64),
                                   np.asarray(js[name], np.float64),
                                   atol=ATOL, rtol=RTOL)


def test_serve_flow_matches_reference(model):
    """launch/serve's flow, greedy. Smallest top-1 lead over the 10
    tokens: granite-8b and qwen2.5-14b 0.0107 (their reduced weights
    are the same draws; largest logit gap 5.3e-6), granite-20b 0.0161
    (5.1e-6), kimi-k2 0.0130 (5.7e-6), kimi at E = 16, k = 8 0.0107
    (7.1e-6)."""
    jc, tc, jp, tp = model
    prompt = tokens(jc, 2, 32, seed=5)
    wp, wl, ws, wt = jax_serve_flow(jc, jp, jnp.asarray(prompt), 10)
    res = serve.run(tc, gen_len=10, device="cpu", params=tp,
                    prompt=t_(prompt))
    _close(res.prefill_logits, wp)
    _close(res.step_logits, ws)
    check_greedy(res.logits[:, -1], wl[:, -1])
    check_greedy(res.step_logits, ws)
    np.testing.assert_array_equal(np_(res.tokens), np.asarray(wt))


@pytest.mark.parametrize("arch", ["granite-8b", "granite-20b",
                                  "qwen2.5-14b", "kimi-k2-1t-a32b"])
def test_serve_command_line_runs_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen-len", "3"]) == 0
    assert "tok/s" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the MoE combine


def _moe_params(mcfg, d, dtype, seed):
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), d, mcfg, jnp.dtype(dtype))
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_moe_block_top8_of_16_matches_reference():
    mcfg = get_config("kimi-k2-1t-a32b").reduced().moe
    mcfg = dataclasses.replace(mcfg, num_experts=16, top_k=8,
                               d_ff_expert=32)
    jp, tp = _moe_params(mcfg, 64, "float32", 0)
    x = np.random.default_rng(1).standard_normal((40, 64)).astype(
        np.float32)
    want, want_aux = JMOE.moe_block(jp, jnp.asarray(x), mcfg)
    got, aux = moe.moe_block(tp, t_(x), mcfg, aux=True)
    want = np.asarray(want, np.float64)
    err = np.abs(np_(got).astype(np.float64) - want).max()
    assert err <= MOE_TOL * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(want_aux), atol=MOE_TOL)


def _combine_inputs(t, k, e, d, seed):
    """Contributions (T*k, d) bf16 in the stable sort's order of T tokens'
    k distinct experts (T, k) each."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    order = np.argsort(idx.reshape(-1), kind="stable")
    contrib = rng.standard_normal((t * k, d)).astype(np.float32)
    return (t_(contrib).to(torch.bfloat16), torch.as_tensor(order),
            torch.as_tensor(idx))


def _numpy_ascending_sum(contrib, order, idx):
    """Each token's contributions in ascending expert order, summed left
    to right from 0 in bfloat16 (ml_dtypes rounds each add)."""
    t, k = idx.shape
    c = contrib.float().numpy().astype(ml_dtypes.bfloat16)
    flat = np.empty_like(c)
    flat[order.numpy()] = c
    flat = flat.reshape(t, k, -1)
    y = np.zeros((t, c.shape[1]), ml_dtypes.bfloat16)
    for tok in range(t):
        for j in np.argsort(idx[tok].numpy()):
            y[tok] = y[tok] + flat[tok, j]
    return y


@pytest.mark.parametrize("k,e", [(8, 16), (8, 384), (4, 16)])
def test_combine_is_the_ascending_sum_bitwise(k, e):
    contrib, order, idx = _combine_inputs(64, k, e, 32, seed=k + e)
    got = moe.combine_ascending(contrib, order, idx)
    want = _numpy_ascending_sum(contrib, order, idx)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_combine_top2_is_index_add_bitwise():
    """mixtral's top-2 combine, one index_add_ by token (0 + a + b in
    either order): bitwise the index_add_ mixtral took before the order
    was pinned, the general ascending sum and numpy's ascending sum."""
    contrib, order, idx = _combine_inputs(256, 2, 8, 64, seed=3)
    stok = torch.arange(256)[:, None].expand(256, 2).reshape(-1)[order]
    old = torch.zeros((256, 64), dtype=torch.bfloat16).index_add_(
        0, stok, contrib)
    got = moe.combine_ascending(contrib, order, idx).view(torch.int16)
    assert torch.equal(got, old.view(torch.int16))
    assert torch.equal(got, moe._ascending_sum(contrib, order, idx).view(
        torch.int16))
    np.testing.assert_array_equal(
        got.numpy(), _numpy_ascending_sum(contrib, order, idx).view(np.int16))


def test_moe_block_top8_bf16_pinned():
    """The block in bf16 at k = 8 twice: bitwise the same."""
    mcfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced().moe,
                               num_experts=16, top_k=8, d_ff_expert=32)
    _, tp = _moe_params(mcfg, 64, "bfloat16", 2)
    x = t_(np.random.default_rng(3).standard_normal((40, 64)).astype(
        np.float32)).to(torch.bfloat16)
    a, _ = moe.moe_block(tp, x, mcfg)
    b, _ = moe.moe_block(tp, x, mcfg)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# ---------------------------------------------------------------------------
# converter, specs, init


@pytest.mark.parametrize("arch", NEW)
def test_converter_carries_every_new_tree_in_bf16(arch):
    """The reference's parameter tree at reduced() in bfloat16 (zamba2's
    stacked mamba_layers and shared block, encdec's encoder, decoder and
    frame_proj, the VLM's patch_proj, kimi's router) -> the port's: same
    paths, shapes and dtypes, every bf16 bit copied."""
    jc = dataclasses.replace(jax_config(arch).reduced(), dtype="bfloat16")
    jp = JR.init_params(jc, jax.random.PRNGKey(1))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        w = np.asarray(w)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        if w.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    keys = set(tp)
    want = {"zamba2-1.2b": {"mamba_layers", "shared"},
            "seamless-m4t-large-v2": {"encoder", "decoder", "frame_proj"},
            "paligemma-3b": {"patch_proj"}}.get(arch, {"layers"})
    assert want <= keys
    if arch == "kimi-k2-1t-a32b":
        assert tp["layers"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_specs_match_reference(arch, shape):
    """input_specs and serve_specs at full width: meta tensors of the
    reference's ShapeDtypeStructs' shapes and dtypes."""
    jc, tc = jax_config(arch), get_config(arch)
    js = INPUT_SHAPES[shape]
    ts = InputShape(js.name, js.seq_len, js.global_batch, js.kind)
    for want, got in ((JR.input_specs(jc, js), R.input_specs(tc, ts)),
                      (JR.serve_specs(jc, js), R.serve_specs(tc, ts))):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (_, w), (_, g) in zip(flat_w, flat_g):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_large_draws_are_sliced(monkeypatch):
    """A draw above SLICE_ELEMS is made in slices along its leading axis,
    in the target dtype, with the requested scale; a draw at or below it
    is the whole float32 draw rounded once, as before."""
    g = torch.Generator().manual_seed(0)
    small = L.dense_init(g, (64, 32), dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    want = torch.randn((64, 32), generator=g).mul_(1 / 8).to(torch.bfloat16)
    assert torch.equal(small.view(torch.int16), want.view(torch.int16))
    monkeypatch.setattr(L, "SLICE_ELEMS", 1024)
    big = L.dense_init(torch.Generator().manual_seed(1), (48, 64, 32),
                       dtype=torch.bfloat16)
    assert big.dtype == torch.bfloat16 and big.shape == (48, 64, 32)
    std = big.float().std().item()
    assert abs(std - 1 / 48 ** 0.5) < 0.01      # fan-in 48
    assert not torch.equal(big[0], big[1])


def test_one_layer_stack_is_a_view_of_the_layer():
    """One layer (kimi-k2 at 1 of 61 layers) is stacked without a second
    copy of its tensors."""
    made = {}

    def layer():
        made["w"] = torch.ones(3, 4)
        return {"w": made["w"], "sub": {"b": torch.zeros(2)}}

    out = L.stack_layers(layer, 1)
    assert out["w"].shape == (1, 3, 4) and out["sub"]["b"].shape == (1, 2)
    assert out["w"].data_ptr() == made["w"].data_ptr()
