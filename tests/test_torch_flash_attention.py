"""The port's flash attention (B4) on the CPU, where it takes its plain
version, against the reference's Pallas kernel (run in interpret mode,
as ``tests/test_kernels.py`` runs it) and its jnp oracle, on the same
numpy inputs.

Tolerance: float32 throughout. The Pallas kernel normalises an online
softmax over key tiles, the plain versions a whole row at once; the
sums differ in order only, a few float32 ulps of values of order 1, so
2e-6 absolute and relative. The two plain versions do the same
arithmetic: 1e-6.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import np_, t_  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.common import view_strides  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    STRIDE_ALIGN, flash_attention_kernel)
from repro_torch.kernels.flash_attention.ops import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref  # noqa: E402

KERNEL_TOL = 2e-6
REF_TOL = 1e-6
MODES = [(True, 0), (False, 0), (True, 8)]     # (causal, window)


def _inputs(b, s, h, kv, d, seed):
    """Model layout: q (B, S, H, D), k/v (B, S, KV, D), float32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 1)])
@pytest.mark.parametrize("s", [16, 40, 64])
def test_plain_matches_pallas_kernel(s, h, kv, causal, window):
    q, k, v = _inputs(2, s, h, kv, 32, seed=s * 10 + h + kv)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, use_kernel=True,
                     interpret=True)
    before = dict(common.LAUNCHES)
    got = flash_attention(t_(q), t_(k), t_(v), causal=causal, window=window)
    assert common.LAUNCHES == before        # the CPU takes the plain version
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(np_(got), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 1)])
def test_plain_matches_reference_oracle(h, kv, causal, window):
    q, k, v = _inputs(2, 40, h, kv, 64, seed=7)
    # the oracles take the kernel layout (B, H, S, D)
    qt, kt, vt = (a.transpose(0, 2, 1, 3) for a in (q, k, v))
    want = jax_ref(jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt),
                   causal=causal, window=window)
    got = attention_ref(t_(qt), t_(kt), t_(vt), causal=causal,
                        window=window)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=REF_TOL,
                               rtol=REF_TOL)


def _jax_plain(q, k, v, causal, window):
    return jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, use_kernel=False)


@pytest.fixture(scope="module")
def warm_reference():
    """The reference's wrapper is jitted: compile each mask mode once,
    before the property loop, so no example pays a compile (ROADMAP
    R3)."""
    q, k, v = _inputs(1, 24, 4, 2, 32, seed=0)
    for causal in (True, False):
        for window in (0, 1, 5, 24):
            _jax_plain(q, k, v, causal, window)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), causal=st.booleans(),
       window=st.sampled_from([0, 1, 5, 24]))
def test_property_plain_matches_reference(warm_reference, seed, causal,
                                          window):
    """Random data, every mask mode, one shape (24 positions, GQA 4/2)."""
    q, k, v = _inputs(1, 24, 4, 2, 32, seed=seed)
    want = _jax_plain(q, k, v, causal, window)
    got = flash_attention(t_(q), t_(k), t_(v), causal=causal, window=window)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=REF_TOL,
                               rtol=REF_TOL)


def test_causal_rows_see_only_the_past():
    """Changing the last key and value moves only the last query row."""
    q, k, v = _inputs(1, 16, 4, 2, 32, seed=3)
    a = flash_attention(t_(q), t_(k), t_(v))
    k2, v2 = k.copy(), v.copy()
    k2[:, -1], v2[:, -1] = 5.0, -5.0
    b = flash_attention(t_(q), t_(k2), t_(v2))
    assert torch.equal(a[:, :-1], b[:, :-1])
    assert not torch.equal(a[:, -1], b[:, -1])


def test_window_one_attends_to_self():
    """window=1 leaves each query only its own key: out = v of its head."""
    q, k, v = _inputs(1, 16, 4, 2, 32, seed=4)
    out = flash_attention(t_(q), t_(k), t_(v), causal=True, window=1)
    want = np.repeat(v, 2, axis=2)           # query head h reads h // 2
    np.testing.assert_allclose(np_(out), want, atol=1e-6, rtol=0)


def test_gqa_heads_must_divide():
    q, k, v = _inputs(1, 16, 3, 2, 32, seed=5)
    with pytest.raises(ValueError, match="do not split"):
        flash_attention(t_(q), t_(k), t_(v))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper checks its arguments before it builds or launches:
    a CPU tensor is refused, nothing is counted."""
    q, k, v = (t_(a).transpose(1, 2).contiguous()
               for a in _inputs(1, 16, 4, 2, 64, seed=6))
    before = common.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="expected CUDA"):
        flash_attention_kernel(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_kernel(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               v[..., :48].contiguous())
    assert common.LAUNCHES["flash_attention"] == before


def test_plain_takes_transposed_views():
    """The model hands ops.flash_attention (B, S, H, D) tensors that may be
    views of other layouts; the result equals the contiguous inputs'."""
    q, k, v = _inputs(2, 40, 4, 2, 64, seed=8)
    # (B, H, S, D) storage seen through a transposed (B, S, H, D) view
    views = [t_(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).transpose(1, 2)
             for a in (q, k, v)]
    assert not any(a.is_contiguous() for a in views)
    before = dict(common.LAUNCHES)
    got = flash_attention(*views, causal=True, window=8)
    assert common.LAUNCHES == before
    want = flash_attention(t_(q), t_(k), t_(v), causal=True, window=8)
    assert torch.equal(got, want)


def _bhsd(seed, dtype=torch.float32, d=64):
    """(B, H, S, D) views of model-layout (B, S, H, D) tensors."""
    return [t_(a).to(dtype).transpose(1, 2)
            for a in _inputs(1, 16, 4, 2, d, seed=seed)]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_kernel_wrapper_refuses_dtype(dtype):
    """A dtype other than float32 / bfloat16 is refused before the build,
    and nothing is counted."""
    q, k, v = _bhsd(9, dtype)
    before = common.LAUNCHES["flash_attention"]
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_kernel(q, k, v)
    assert common.LAUNCHES["flash_attention"] == before


def test_kernel_wrapper_refuses_mixed_dtypes():
    q, k, v = _bhsd(10)
    before = common.LAUNCHES["flash_attention"]
    with pytest.raises(TypeError, match="k: dtype"):
        flash_attention_kernel(q, k.to(torch.bfloat16), v)
    assert common.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_kernel_wrapper_refuses_strided_last_dim(which):
    """A last dim that is not unit-stride (here: every other element of a
    wider tensor) is refused before the build; nothing is counted."""
    args = dict(zip("qkv", _bhsd(11)))
    wide = torch.zeros(args[which].shape[:-1] + (128,))
    args[which] = wide[..., ::2]
    assert args[which].stride(-1) == 2
    before = common.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match=f"{which}: last dim has stride 2"):
        flash_attention_kernel(args["q"], args["k"], args["v"])
    assert common.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrapper_refuses_cpu_views(dtype):
    """Model-layout views that the kernel would take on CUDA are refused
    on the CPU, after every other check passed."""
    q, k, v = _bhsd(12, dtype)
    before = common.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="q: on cpu, expected CUDA"):
        flash_attention_kernel(q, k, v)
    assert common.LAUNCHES["flash_attention"] == before


def test_kernel_strides_of_model_layout():
    """The (batch, head, position) strides the kernel's TMA maps get: the
    model's (B, S, H, D) layout seen as (B, H, S, D), a fused QKV slice,
    and a size-1 dim whose stride is never stepped."""
    b, s, h, d = 2, 5, 3, 64
    x = torch.zeros(b, s, h, d).transpose(1, 2)
    assert view_strides(x, "q", STRIDE_ALIGN) == (s * h * d, d, h * d)
    qkv = torch.zeros(b, s, (h + 4) * d)
    q = qkv[..., :h * d].view(b, s, h, d).transpose(1, 2)
    assert view_strides(q, "q", STRIDE_ALIGN) == (s * (h + 4) * d, d,
                                                  (h + 4) * d)
    one = torch.zeros(1, 1, s, d).as_strided((1, 1, s, d), (3, 3, d, 1))
    assert view_strides(one, "k", STRIDE_ALIGN) == (STRIDE_ALIGN,
                                                    STRIDE_ALIGN, d)
    odd = torch.zeros(b, s, h, d + 4)[..., :d].transpose(1, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        view_strides(odd, "v", STRIDE_ALIGN)
