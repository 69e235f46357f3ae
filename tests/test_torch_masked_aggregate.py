"""The port's masked aggregation (rank-3 (seed, ES, slot) layout)
against the reference's ``masked_aggregate_stacked``."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import np_, t_  # noqa: E402
from repro.kernels.masked_aggregate.ops import \
    masked_aggregate_stacked as jax_stacked  # noqa: E402
from repro_torch.kernels.masked_aggregate.ops import (  # noqa: E402
    masked_aggregate_flat, masked_aggregate_rows, masked_aggregate_stacked)
from repro_torch.kernels.masked_aggregate.ref import \
    masked_aggregate_ref  # noqa: E402

RTOL = ATOL = 1e-6   # float32 sums over <= 40 slots in another order


def _inputs(s, m, slots, seed, kind):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((s, m, 12, 10)).astype(np.float32),
              "b": rng.standard_normal((s, m, 10)).astype(np.float32)}
    deltas = {"w": rng.standard_normal((s, m, slots, 12, 10))
              .astype(np.float32) * 0.1,
              "b": rng.standard_normal((s, m, slots, 10))
              .astype(np.float32) * 0.1}
    w = (rng.random((s, m, slots)) < 0.6).astype(np.float32)
    if kind == "zero":
        w[:] = 0.0
    elif kind == "padded":
        w[..., slots // 2:] = 0.0
        for k in deltas:
            deltas[k][:, :, slots // 2:] = 1e20   # finite, never weighted
    elif kind == "weighted":
        w = rng.uniform(0.0, 2.0, (s, m, slots)).astype(np.float32)
    return params, deltas, w


@pytest.mark.parametrize("kind", ["random", "zero", "padded", "weighted"])
@pytest.mark.parametrize("s,m,slots", [(2, 12, 9), (1, 3, 1), (3, 2, 40)])
def test_stacked_matches_reference(s, m, slots, kind):
    params, deltas, w = _inputs(s, m, slots, s * 100 + slots, kind)
    want = jax_stacked({k: jnp.asarray(v) for k, v in params.items()},
                       {k: jnp.asarray(v) for k, v in deltas.items()},
                       jnp.asarray(w))
    got = masked_aggregate_stacked({k: t_(v) for k, v in params.items()},
                                   {k: t_(v) for k, v in deltas.items()},
                                   t_(w))
    for k in params:
        assert got[k].shape == params[k].shape
        np.testing.assert_allclose(np_(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)
    if kind == "zero":          # nothing arrived: params unchanged
        for k in params:
            assert np.array_equal(np_(got[k]), params[k])


def test_flat_cpu_route_is_plain_version():
    rng = np.random.default_rng(0)
    p = t_(rng.standard_normal((4, 33)).astype(np.float32))
    d = t_(rng.standard_normal((4, 5, 33)).astype(np.float32))
    w = t_(rng.random((4, 5)).astype(np.float32))
    assert torch.equal(masked_aggregate_flat(p, d, w),
                       masked_aggregate_ref(p, d, w))


@pytest.mark.parametrize("kind", ["random", "padded"])
@pytest.mark.parametrize("s,m,slots", [(2, 12, 9), (3, 2, 40)])
def test_rows_on_flat_buffer_matches_stacked(s, m, slots, kind):
    """The training loop's entry (deltas already side by side in one
    (S*M, slots, D) buffer) equals the dict entry bitwise."""
    params, deltas, w = _inputs(s, m, slots, s + slots, kind)
    tp = {k: t_(v) for k, v in params.items()}
    flat = torch.cat([t_(deltas[k]).reshape(s * m, slots, -1)
                      for k in params], dim=2)
    got = masked_aggregate_rows(tp, flat, t_(w))
    want = masked_aggregate_stacked(tp, {k: t_(v) for k, v in
                                         deltas.items()}, t_(w))
    for k in params:
        assert torch.equal(got[k], want[k])


def test_rows_need_seed_es_slot_weights():
    params, deltas, w = _inputs(1, 3, 4, 0, "random")
    tp = {k: t_(v)[0] for k, v in params.items()}
    flat = torch.zeros((3, 4, 130))
    with pytest.raises(ValueError, match="S, M, slots"):
        masked_aggregate_rows(tp, flat, t_(w)[0])


# -- the CUDA kernel's order of work, mirrored in numpy --------------------

GROUP = 8       # csrc/masked_aggregate.cu, kGroup


def _grouped_mirror(params, deltas, weights, v):
    """float32 numpy mirror of ``csrc/masked_aggregate.cu``: a thread owns
    ``v`` adjacent columns; it loads a group of GROUP slots, then adds
    them in slot order (one multiply and one add each), group after
    group, the last group cut at ``slots``; one thread of the row sums
    the weights in slot order into the denominator max(sum, 1)."""
    r, slots, d = deltas.shape
    assert d % v == 0
    out = np.empty((r, d), np.float32)
    for row in range(r):
        denom = np.float32(0.0)
        for s in range(slots):
            denom = np.float32(denom + weights[row, s])
        denom = max(denom, np.float32(1.0))
        acc = np.zeros((d // v, v), np.float32)   # every thread of the row
        for s0 in range(0, slots, GROUP):
            n = min(GROUP, slots - s0)
            buf = deltas[row, s0:s0 + n].reshape(n, d // v, v)  # the loads
            for j in range(n):
                acc = acc + weights[row, s0 + j] * buf[j]
        out[row] = params[row] + acc.reshape(d) / denom
    return out


def _flat(r, slots, d, seed, kind):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((r, d)).astype(np.float32)
    dl = (rng.standard_normal((r, slots, d)) * 0.01).astype(np.float32)
    w = (rng.random((r, slots)) < 0.7).astype(np.float32)
    if kind == "zero":
        w[:] = 0.0
    elif kind == "padded":          # padded slots: weight 0, finite garbage
        w[:, slots // 2:] = 0.0
        dl[:, slots // 2:] = 1e30
    elif kind == "weighted":
        w = rng.uniform(0.0, 2.0, (r, slots)).astype(np.float32)
    return p, dl, w


@pytest.mark.parametrize("kind", ["random", "zero", "padded", "weighted"])
@pytest.mark.parametrize("slots", [1, 7, 8, 9, 27, 40])
@pytest.mark.parametrize("d", [1, 257, 7850])
def test_grouped_mirror_is_bitwise_plain(d, slots, kind):
    r = 2 if d == 7850 else 3
    p, dl, w = _flat(r, slots, d, d + slots, kind)
    want = np_(masked_aggregate_ref(t_(p), t_(dl), t_(w)))
    for v in (1, 2) if d % 2 == 0 else (1,):
        got = _grouped_mirror(p, dl, w, v)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    if kind == "zero":
        np.testing.assert_array_equal(want, p)


def test_wrapper_refuses_too_many_slots_before_any_build(monkeypatch):
    """The slot limit (weights and denominator in 48 KB of shared
    memory) is checked first, so it raises on the CPU too."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.masked_aggregate.kernel import (
        MAX_SLOTS, masked_aggregate_kernel)

    def no_build(name):
        raise AssertionError("built")
    monkeypatch.setattr(_build, "load", no_build)
    assert (MAX_SLOTS + 1) * 4 == 48 * 1024
    s = MAX_SLOTS + 1
    with pytest.raises(ValueError, match="slots"):
        masked_aggregate_kernel(torch.zeros(1, 1), torch.zeros(1, s, 1),
                                torch.zeros(1, s))
