"""The non-convex setting's CNN against the reference's, on the CPU:
``init_cnn`` within ``NORMAL_MAX_ULP + 1`` ulp (its normals, then a
division), and, from the reference's params carried across
(``cnn_params_from_jax``), logits, loss, gradients and one SGD step
within ``CNN_TOL``. Per-slot training (``cnn_loss_and_grad``, one model a
slot under ``vmap``) equals training each model alone. Reference caveat
R11 is pinned: at ``CIFAR10_NONCONVEX``'s lr = 0.1 plain SGD on one
client blows up on both packages, at 0.005 it falls on both."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import NORMAL_MAX_ULP, t_, ulp_gap  # noqa: E402
from repro.configs.paper_hfl import CIFAR10_NONCONVEX as JNC  # noqa: E402
from repro.configs.paper_hfl import CONFIGS as J_CONFIGS  # noqa: E402
from repro.data.federated import FederatedDataset as JData  # noqa: E402
from repro.models.logistic import cnn_logits as jax_logits  # noqa: E402
from repro.models.logistic import init_cnn as jax_init  # noqa: E402
from repro.models.logistic import make_loss_fn as jax_loss_fn  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.configs.paper_hfl import (CIFAR10_NONCONVEX,  # noqa: E402
                                           CONFIGS)
from repro_torch.fed.client import sgd_steps  # noqa: E402
from repro_torch.models import logistic as L  # noqa: E402
from repro_torch.models.convert import (cnn_params_from_jax,  # noqa: E402
                                        cnn_params_to_numpy)

# float32 convolutions and products summed in another order than XLA's,
# values of order 1 (measured 1.2e-6 on logits, 3e-7 on gradients)
CNN_TOL = 1e-5


def _ref_params(seed, h, w):
    return {k: np.asarray(v) for k, v in
            jax_init(jax.random.PRNGKey(seed), h, w, 3).items()}


def _batch(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, w, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def test_config_is_the_reference_one():
    from dataclasses import asdict
    assert asdict(CIFAR10_NONCONVEX) == asdict(JNC)
    assert CONFIGS["cifar10-nonconvex"] is CIFAR10_NONCONVEX
    # the reference's registry, the mesh-scale cohorts included
    assert sorted(CONFIGS) == sorted(J_CONFIGS)
    for name, cfg in J_CONFIGS.items():
        assert asdict(CONFIGS[name]) == asdict(cfg), name


@pytest.mark.parametrize("h,w,seed", [(16, 16, 0), (32, 32, 3)])
def test_init_within_normal_ulp(h, w, seed):
    want = _ref_params(seed, h, w)
    got = cnn_params_to_numpy(L.init_cnn(jr.PRNGKey(seed), h, w), h, w)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert ulp_gap(want[k], got[k]) <= NORMAL_MAX_ULP + 1, k
    n = sum(v.size for v in want.values())
    assert n == (1_756_426 if h == 32 else 576_778)


def test_layout_round_trip():
    want = _ref_params(1, 16, 16)
    back = cnn_params_to_numpy(cnn_params_from_jax(want, 16, 16), 16, 16)
    for k in want:
        assert np.array_equal(want[k], back[k]), k


def test_logits_loss_grads_and_step():
    h = w = 16
    jp = _ref_params(2, h, w)
    tp = cnn_params_from_jax(jp, h, w)
    x, y = _batch(16, h, w, 0)
    want = np.asarray(jax.jit(jax_logits)(jp, x))
    got = L.cnn_logits(tp, t_(x)).numpy()
    assert np.abs(want - got).max() <= CNN_TOL
    loss_fn = jax_loss_fn("cnn")
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jp, {"x": x, "y": y})
    one = {k: v[None] for k, v in tp.items()}
    tl, tg = L.cnn_loss_and_grad(one, t_(x)[None], t_(y)[None])
    assert abs(float(jl) - float(tl[0])) <= CNN_TOL
    tg = cnn_params_to_numpy({k: v[0] for k, v in tg.items()}, h, w)
    for k in jg:
        assert np.abs(np.asarray(jg[k]) - tg[k]).max() <= CNN_TOL, k
    # one SGD step: w - lr * g, as the reference's local_sgd
    lr = 0.005
    stepped = {k: np.asarray(jp[k] - lr * jg[k]) for k in jp}
    p, _ = sgd_steps(one, {"x": t_(x)[None, None], "y": t_(y)[None, None]},
                     lr, "cnn")
    p = cnn_params_to_numpy({k: v[0] for k, v in p.items()}, h, w)
    for k in stepped:
        assert np.abs(stepped[k] - p[k]).max() <= CNN_TOL, k
    assert float(L.make_loss_fn("cnn")(tp, {"x": t_(x), "y": t_(y)})) \
        == pytest.approx(float(jl), abs=CNN_TOL)


def test_slots_train_as_separate_models():
    """Three slots, three models and batches, under vmap: each slot's
    loss and gradient are those of its model alone."""
    h = w = 8
    trees = [cnn_params_from_jax(_ref_params(s, h, w), h, w)
             for s in range(3)]
    slots = {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    xs, ys = zip(*(_batch(4, h, w, s) for s in range(3)))
    x, y = t_(np.stack(xs)), t_(np.stack(ys))
    loss, grads = L.cnn_loss_and_grad(slots, x, y)
    for s in range(3):
        one = {k: v[None] for k, v in trees[s].items()}
        l1, g1 = L.cnn_loss_and_grad(one, x[s:s + 1], y[s:s + 1])
        assert abs(float(loss[s]) - float(l1[0])) <= CNN_TOL
        for k in g1:
            assert (grads[k][s] - g1[k][0]).abs().max() <= CNN_TOL, k


def _sgd_run(lr, steps=10, batch=32):
    """Plain SGD on client 0 of the reference's cifar data from
    ``init_cnn(PRNGKey(0))``: minibatch k is samples 32k .. 32k + 31 of
    the client's shard, cyclically. Returns each package's train losses
    by step and its test loss after the steps."""
    data = JData.synthetic(50, kind="cifar", seed=0)
    cx, cy = data.clients[0].x, data.clients[0].y
    tx, ty = data.test_x[:500], data.test_y[:500]
    idx = [np.arange(k * batch, (k + 1) * batch) % len(cy)
           for k in range(steps)]
    loss_fn = jax_loss_fn("cnn")
    grad = jax.jit(jax.value_and_grad(loss_fn))
    p = _ref_params(0, 32, 32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    j_losses = []
    for i in idx:
        val, g = grad(jp, {"x": cx[i], "y": cy[i]})
        j_losses.append(float(val))
        jp = jax.tree.map(lambda a, b: a - lr * b, jp, g)
    j_test = float(jax.jit(loss_fn)(jp, {"x": tx, "y": ty}))
    tp = {k: v[None] for k, v in cnn_params_from_jax(p, 32, 32).items()}
    t_losses = []
    for i in idx:
        val, g = L.cnn_loss_and_grad(tp, t_(cx[i])[None], t_(cy[i])[None])
        t_losses.append(float(val[0]))
        tp = {k: tp[k] - lr * g[k] for k in tp}
    t_test = float(L.make_loss_fn("cnn")({k: v[0] for k, v in tp.items()},
                                         {"x": t_(tx), "y": t_(ty)}))
    return np.array(j_losses), j_test, np.array(t_losses), t_test


def test_r11_reference_diverges_at_its_own_lr():
    """At lr = 0.1 the train loss climbs orders of magnitude above its
    start on both packages, so does the test loss or it is not finite;
    at lr = 0.005 both fall, and the two packages agree step by step."""
    jl, jt, tl, tt = _sgd_run(0.1)
    print(f"lr 0.1: reference train losses {jl.tolist()}, test loss {jt}")
    print(f"lr 0.1: port      train losses {tl.tolist()}, test loss {tt}")
    for losses, test in ((jl, jt), (tl, tt)):
        assert np.nanmax(losses) > 100 * losses[0]
        assert not np.isfinite(test) or test > 100 * losses[0]
    assert abs(jl[0] - tl[0]) <= CNN_TOL * max(1.0, abs(jl[0]))
    jl, jt, tl, tt = _sgd_run(0.005)
    print(f"lr 0.005: reference train losses {jl.tolist()}, test loss {jt}")
    print(f"lr 0.005: port      train losses {tl.tolist()}, test loss {tt}")
    for losses, test in ((jl, jt), (tl, tt)):
        assert losses[-1] < losses[0] and np.isfinite(test)
    assert np.abs(jl - tl).max() <= 1e-3 * np.abs(jl).max()
    assert abs(jt - tt) <= 1e-3 * abs(jt)
