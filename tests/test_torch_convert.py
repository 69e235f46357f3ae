"""Parameters carried from the reference into the port, and the port's
logreg loss and local SGD against the reference's from the same
parameters."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import bitwise, np_, t_  # noqa: E402
from repro.fed.client import local_sgd_multi as jax_sgd  # noqa: E402
from repro.models.logistic import make_loss_fn as jax_loss  # noqa: E402
from repro_torch.fed.batched import BatchedRoundSpec, slot_train  # noqa
from repro_torch.fed.client import local_sgd_multi  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        to_numpy_params)
from repro_torch.models.logistic import make_loss_fn  # noqa: E402

RTOL = 1e-5   # float32 matmuls and softmax summed in another order


def _params(k, f, c, seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((k, f, c)) * 0.1).astype(np.float32),
            "b": (rng.standard_normal((k, c)) * 0.1).astype(np.float32)}


def _batches(k, steps, b, f, c, seed):
    rng = np.random.default_rng(seed + 1)
    return {"x": rng.standard_normal((k, steps, b, f)).astype(np.float32),
            "y": rng.integers(0, c, (k, steps, b)).astype(np.int32)}


def test_from_jax_params_round_trip():
    p = {k: np.asarray(v) for k, v in jax.tree.map(
        jnp.asarray, _params(3, 7, 4, 0)).items()}
    t = from_jax_params(p)
    assert all(isinstance(v, torch.Tensor) for v in t.values())
    back = to_numpy_params(t)
    for k in p:
        assert bitwise(p[k], back[k]) and back[k].dtype == p[k].dtype


@pytest.mark.parametrize("seed", [0, 1])
def test_logreg_loss_matches_reference(seed):
    p = _params(1, 784, 10, seed)
    p1 = {k: v[0] for k, v in p.items()}
    b = _batches(1, 1, 32, 784, 10, seed)
    batch = {"x": b["x"][0, 0], "y": b["y"][0, 0]}
    want = float(jax_loss("logreg")({k: jnp.asarray(v) for k, v in
                                     p1.items()},
                                    {k: jnp.asarray(v) for k, v in
                                     batch.items()}))
    got = float(make_loss_fn("logreg")(from_jax_params(p1),
                                       {k: t_(v) for k, v in batch.items()}))
    assert abs(got - want) <= RTOL * abs(want)


@pytest.mark.parametrize("steps,seed", [(1, 0), (4, 1)])
def test_local_sgd_multi_matches_reference(steps, seed):
    k, f, c, b, lr = 5, 784, 10, 32, 0.005
    p = _params(k, f, c, seed)
    bt = _batches(k, steps, b, f, c, seed)
    want, _ = jax_sgd({n: jnp.asarray(v) for n, v in p.items()},
                      jax_loss("logreg"),
                      {n: jnp.asarray(v) for n, v in bt.items()}, lr,
                      per_client_params=True)
    got, losses = local_sgd_multi(from_jax_params(p),
                                  {n: t_(v) for n, v in bt.items()}, lr)
    assert losses.shape == (k,)
    for n in p:
        np.testing.assert_allclose(np_(got[n]), np.asarray(want[n]),
                                   rtol=RTOL, atol=RTOL * 1e-2)


@pytest.mark.parametrize("steps,seed", [(1, 0), (4, 1)])
def test_slot_train_writes_deltas_side_by_side(steps, seed):
    """slot_train's (K, D) buffer holds local_sgd_multi's deltas, the
    leaves flattened in dict order, bitwise."""
    k, f, c, b = 5, 784, 10, 32
    spec = BatchedRoundSpec(num_edge_servers=1, steps=steps, lr=0.005,
                            z_min=1, t_es=1)
    p = from_jax_params(_params(k, f, c, seed))
    bt = {n: t_(v) for n, v in _batches(k, steps, b, f, c, seed).items()}
    out = torch.full((k, f * c + c), torch.nan)
    got = slot_train(p, bt, spec, out)
    assert got.data_ptr() == out.data_ptr()
    want, _ = local_sgd_multi(p, bt, spec.lr)
    assert torch.equal(got, torch.cat([want["w"].reshape(k, -1),
                                       want["b"]], dim=1))
