"""The port's Mamba2 SSD pieces against the reference, on the CPU, float32:
the inclusive chunked recurrence and its step form
(``repro_torch.models.layers``), the causal conv with its carry, and
``mamba_mix``/``mamba_mix_step`` at zamba2-1.2b's ``reduced()`` size
with the reference's own parameters (``lm_params_from_jax``).

The error measure is relative to the scale of the reference's output:
max |got - want| / max |want|. Tolerances:
  * the chunked form and the step form against the reference's per-step
    oracle ``linear_recurrence_ref``: 1e-4 (another order of float32
    sums over up to 200 steps; the chunked form's decays are differences
    of cumulative sums, exact to ~|lcum| x 2^-24);
  * the chunked form against the reference's chunked form where that is
    finite: 1e-5 (the same chunks, factors taken as differences rather
    than products);
  * the blocks: 1e-5.

R12: the reference's chunked form scales k by exp(-cumsum log_w) within
a chunk, inf in float32 past a cumulative decay of -88.7; at zamba2's
chunk of 128 and dt 0.8 its output is not finite. The port's form keeps
every factor <= 1.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import np_, one_torch_thread, t_  # noqa: E402,F401
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ORACLE_TOL = 1e-4
CHUNKED_TOL = 1e-5
BLOCK_TOL = 1e-5


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np_(got).astype(np.float64) - want).max()
                 / np.abs(want).max())


def _inputs(b, h, t, dk, dv, seed, dt=(0.01, 1.0), per_channel=False):
    """r, k, v N(0, 1); log_w = -dt with dt uniform in ``dt``, one a head
    and step (B, H, T, 1) or, with ``per_channel``, (B, H, T, dk); a
    state N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, h, t, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, t, dv)).astype(np.float32)
    lw = -rng.uniform(*dt, (b, h, t, dk if per_channel else 1))
    s0 = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    return r, k, v, lw.astype(np.float32), s0


def _oracle(r, k, v, lw, s0=None):
    lw = np.broadcast_to(lw, r.shape)
    return JL.linear_recurrence_ref(
        *map(jnp.asarray, (r, k, v, lw)),
        init_state=None if s0 is None else jnp.asarray(s0))


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("t", [32, 64, 128, 200])
def test_inclusive_chunked_matches_per_step_oracle(t, chunk, init):
    r, k, v, lw, s0 = _inputs(2, 3, t, 16, 8, seed=t + chunk + init)
    s0 = s0 if init else None
    wy, ws = _oracle(r, k, v, lw, s0)
    gy, gs = L.chunked_linear_recurrence(
        *map(t_, (r, k, v, lw)), chunk=chunk,
        init_state=None if s0 is None else t_(s0))
    assert gy.shape == (2, 3, t, 8) and gs.shape == (2, 3, 16, 8)
    assert _rel(gy, wy) < ORACLE_TOL
    assert _rel(gs, ws) < ORACLE_TOL


@pytest.mark.parametrize("t", [64, 200])
def test_inclusive_chunked_per_channel_decay_matches_oracle(t):
    """A decay per state row (B, H, T, dk), the form's general case."""
    r, k, v, lw, s0 = _inputs(1, 2, t, 8, 8, seed=t, per_channel=True)
    wy, ws = _oracle(r, k, v, lw, s0)
    gy, gs = L.chunked_linear_recurrence(*map(t_, (r, k, v, lw)), chunk=32,
                                         init_state=t_(s0))
    assert _rel(gy, wy) < ORACLE_TOL and _rel(gs, ws) < ORACLE_TOL


@pytest.mark.parametrize("init", [False, True])
def test_inclusive_step_matches_per_step_oracle(init):
    """``linear_recurrence_step`` with u=None over 200 steps: the new state
    is queried."""
    r, k, v, lw, s0 = _inputs(2, 3, 200, 16, 8, seed=9)
    s0 = s0 if init else None
    wy, ws = _oracle(r, k, v, lw, s0)
    st = torch.zeros(2, 3, 16, 8) if s0 is None else t_(s0)
    ys = []
    for i in range(200):
        y, st = L.linear_recurrence_step(*(t_(a[:, :, i]) for a in
                                           (r, k, v, lw)), st)
        ys.append(y)
    assert _rel(torch.stack(ys, 2), wy) < ORACLE_TOL
    assert _rel(st, ws) < ORACLE_TOL


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("t,chunk", [(64, 32), (128, 64), (128, 32)])
def test_inclusive_chunked_matches_reference_chunked(t, chunk, init):
    """Where the reference's chunked form is finite (dt <= 0.5: cumulative
    decays above -64 within a chunk)."""
    r, k, v, lw, s0 = _inputs(2, 3, t, 16, 8, seed=t * chunk + init,
                              dt=(0.01, 0.5))
    s0 = s0 if init else None
    wy, ws = JL.chunked_linear_recurrence(
        *map(jnp.asarray, (r, k, v, np.broadcast_to(lw, r.shape))),
        chunk=chunk, init_state=None if s0 is None else jnp.asarray(s0))
    assert np.isfinite(np.asarray(wy)).all()
    gy, gs = L.chunked_linear_recurrence(
        *map(t_, (r, k, v, lw)), chunk=chunk,
        init_state=None if s0 is None else t_(s0))
    assert _rel(gy, wy) < CHUNKED_TOL
    assert _rel(gs, ws) < CHUNKED_TOL


def test_r12_reference_chunk_of_128_overflows_and_the_port_does_not():
    """At zamba2's chunk of 128 and a constant dt of 0.8 the cumulative
    decay reaches -102.4: the reference's chunked output is not finite;
    the port's is finite and within ORACLE_TOL of the per-step oracle."""
    b, h, t, n, p = 1, 4, 128, 64, 64
    r, k, v, _, _ = _inputs(b, h, t, n, p, seed=12)
    lw = np.full((b, h, t, 1), -0.8, np.float32)
    wy, _ = JL.chunked_linear_recurrence(
        *map(jnp.asarray, (r, k, v, np.broadcast_to(lw, r.shape))),
        chunk=128)
    assert not np.isfinite(np.asarray(wy)).all()
    oy, os_ = _oracle(r, k, v, lw)
    gy, gs = L.chunked_linear_recurrence(*map(t_, (r, k, v, lw)), chunk=128)
    assert torch.isfinite(gy).all() and torch.isfinite(gs).all()
    assert _rel(gy, oy) < ORACLE_TOL and _rel(gs, os_) < ORACLE_TOL


def test_exclusive_form_takes_no_initial_state():
    r, k, v, lw, s0 = map(t_, _inputs(1, 2, 32, 64, 64, seed=3,
                                      per_channel=True))
    with pytest.raises(ValueError, match="zero state"):
        L.chunked_linear_recurrence(r, k, v, lw, chunk=32,
                                    u=torch.zeros(2, 64), init_state=s0)


# ---------------------------------------------------------------------------
# the block at zamba2-1.2b's reduced() size


@pytest.fixture(scope="module")
def block():
    jc = jax_config("zamba2-1.2b").reduced()
    tc = get_config("zamba2-1.2b").reduced()
    jp = JM.init_mamba(jax.random.PRNGKey(0), jc, jnp.float32)
    # a_log and dt_bias away from 0, so decays differ across heads (and
    # stay where the reference's chunks of 32 are finite)
    rng = np.random.default_rng(0)
    jp = dict(jp, a_log=jnp.asarray(rng.uniform(-2, -0.5,
                                                jp["a_log"].shape),
                                    jnp.float32),
              dt_bias=jnp.asarray(rng.uniform(-1, 0, jp["dt_bias"].shape),
                                  jnp.float32),
              conv_b=jnp.asarray(rng.standard_normal(jp["conv_b"].shape)
                                 * 0.1, jnp.float32))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _x(cfg, b, t, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_reference(block, carry):
    jc, tc, jp, tp = block
    rng = np.random.default_rng(4)
    xbc = rng.standard_normal((2, 9, jp["conv_w"].shape[1])).astype(
        np.float32)
    c0 = rng.standard_normal((2, 3, xbc.shape[2])).astype(np.float32) \
        if carry else None
    wo, wc = JM._causal_conv(jnp.asarray(xbc), jp["conv_w"], jp["conv_b"],
                             None if c0 is None else jnp.asarray(c0))
    go, gc = M._causal_conv(t_(xbc), tp["conv_w"], tp["conv_b"],
                            None if c0 is None else t_(c0))
    np.testing.assert_allclose(np_(go), np.asarray(wo), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(np_(gc), np.asarray(wc))


def test_split_matches_reference(block):
    jc, tc, jp, tp = block
    proj = _x(jc, 1, 2, 5) @ np.asarray(jp["in_proj"])
    for g, w in zip(M._split(tc, t_(proj)), JM._split(jc, jnp.asarray(proj))):
        np.testing.assert_array_equal(np_(g), np.asarray(w))


@pytest.mark.parametrize("states", [False, True])
def test_mamba_mix_matches_reference(block, states):
    """64 steps (two chunks of 32), from zero states or given ones."""
    jc, tc, jp, tp = block
    x = _x(jc, 2, 64, 6)
    ssm_shape, conv_shape = JM.ssm_state_shapes(jc, 2)
    rng = np.random.default_rng(7)
    s0 = rng.standard_normal(ssm_shape).astype(np.float32) if states \
        else None
    c0 = rng.standard_normal(conv_shape).astype(np.float32) if states \
        else None
    wo, ws, wc = JM.mamba_mix(jp, jnp.asarray(x), jc,
                              None if s0 is None else jnp.asarray(s0),
                              None if c0 is None else jnp.asarray(c0))
    go, gs, gc = M.mamba_mix(tp, t_(x), tc,
                             None if s0 is None else t_(s0),
                             None if c0 is None else t_(c0))
    assert _rel(go, wo) < BLOCK_TOL
    assert _rel(gs, ws) < BLOCK_TOL
    # the carry is the last inputs to the conv, in_proj's products
    assert _rel(gc, wc) < BLOCK_TOL


def test_mamba_mix_step_matches_reference(block):
    """12 decode steps from the state a 32-step prompt left: the step form
    against the reference's chunked form at T = 1."""
    jc, tc, jp, tp = block
    x = _x(jc, 2, 44, 8)
    _, ws, wc = JM.mamba_mix(jp, jnp.asarray(x[:, :32]), jc)
    _, gs, gc = M.mamba_mix(tp, t_(x[:, :32]), tc)
    for i in range(32, 44):
        wo, ws, wc = JM.mamba_mix_step(jp, jnp.asarray(x[:, i]), jc, ws, wc)
        go, gs, gc = M.mamba_mix_step(tp, t_(x[:, i]), tc, gs, gc)
        assert go.shape == (2, jc.d_model)
        assert _rel(go, wo) < BLOCK_TOL
    assert _rel(gs, ws) < BLOCK_TOL
    assert _rel(gc, wc) < BLOCK_TOL


def test_mamba_mix_chunked_equals_its_steps(block):
    """The prompt form over 64 steps and the step form fed the same 64
    inputs one at a time: one function."""
    jc, tc, jp, tp = block
    x = t_(_x(jc, 2, 64, 9))
    out, fin, conv = M.mamba_mix(tp, x, tc)
    ssm_shape, conv_shape = M.ssm_state_shapes(tc, 2)
    s, c = torch.zeros(ssm_shape), torch.zeros(conv_shape)
    steps = []
    for i in range(64):
        o, s, c = M.mamba_mix_step(tp, x[:, i], tc, s, c)
        steps.append(o)
    assert _rel(torch.stack(steps, 1), np_(out)) < BLOCK_TOL
    assert _rel(s, np_(fin)) < BLOCK_TOL
    assert _rel(c, np_(conv)) < BLOCK_TOL


def test_ssm_state_shapes_match_reference():
    for arch in ("zamba2-1.2b",):
        for reduced in (False, True):
            jc, tc = jax_config(arch), get_config(arch)
            if reduced:
                jc, tc = jc.reduced(), tc.reduced()
            assert M.ssm_state_shapes(tc, 3) == JM.ssm_state_shapes(jc, 3)
