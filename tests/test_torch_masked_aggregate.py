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
