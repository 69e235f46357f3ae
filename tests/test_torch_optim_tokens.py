"""The port's optimizers, schedules and token shards against the
reference's, on the CPU.

* ``sgd``, ``momentum`` (plain and Nesterov) and ``adamw`` (with and
  without weight decay) take five steps from the same numpy parameters
  and gradients (a nested tree, float32 leaves and one bfloat16 leaf)
  in both packages; every float32 parameter and state leaf within 1e-6
  (the same float32 operations; measured equal, on values up to 5.3),
  the bf16 leaf within one of its ulps, AdamW's ``count`` equal.
* ``constant``, ``cosine_decay`` and ``warmup_cosine`` at every step of a
  range, within 1e-6 (lr values below 1; measured up to 7.5e-9, the
  reference dividing the step in float64 before rounding).
* ``client_token_shards``: the same numpy code, so every sampled batch
  of every client is bitwise the reference's.
"""
import ml_dtypes
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import np_, one_torch_thread  # noqa: E402,F401
from repro import optim as JO  # noqa: E402
from repro.data import tokens as JTOK  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.data import tokens as TTOK  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-6
STEPS = 5
OPTIMIZERS = {
    "sgd": ((), {}),
    "momentum": ((), {"beta": 0.9}),
    "nesterov": ((), {"beta": 0.8, "nesterov": True}),
    "adamw": ((), {}),
    "adamw-wd": ((), {"b1": 0.85, "b2": 0.99, "weight_decay": 0.1}),
}


def _tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blk": {"b": rng.standard_normal((5,)).astype(np.float32),
                    "h": rng.standard_normal((3, 4)).astype(
                        ml_dtypes.bfloat16)}}


def _make(pkg, name):
    args, kw = OPTIMIZERS[name]
    factory = name.split("-")[0]
    if factory == "nesterov":
        factory = "momentum"
    return getattr(pkg, factory)(*args, **kw)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _close(got, want, what):
    g = np_(got.to(torch.float32) if isinstance(got, torch.Tensor)
            and got.dtype == torch.bfloat16 else got).astype(np.float64)
    w = np.asarray(want).astype(np.float64)
    tol = TOL if np.asarray(want).dtype != ml_dtypes.bfloat16 else \
        2.0 ** -7 * max(1.0, float(np.abs(w).max()))
    assert np.abs(g - w).max() <= tol, (what, np.abs(g - w).max())


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_the_reference(name):
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    jopt, topt = _make(JO, name), _make(TO, name)
    jp = jax.tree.map(jnp.asarray, params)
    tp = lm_params_from_jax(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i, g in enumerate(grads):
        lr = 0.05 * (i + 1)
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, lr)
        jp = JO.apply_updates(jp, upd)
        upd, ts = topt.update(lm_params_from_jax(g), ts, tp, lr)
        tp = TO.apply_updates(tp, upd)
    for a, b in zip(_leaves(tp), _leaves(jax.tree.map(np.asarray, jp))):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        _close(a, b, f"{name} params")
    if name.startswith("adamw"):
        assert int(ts["count"]) == int(js["count"]) == STEPS
        assert ts["count"].dtype == torch.int32
        for key in ("mu", "nu"):
            for a, b in zip(_leaves(ts[key]), _leaves(js[key])):
                assert a.dtype == torch.float32
                _close(a, b, f"{name} {key}")
    elif name != "sgd":
        for a, b in zip(_leaves(ts), _leaves(js)):
            assert a.dtype == torch.float32
            _close(a, b, f"{name} momentum")


@pytest.mark.parametrize("sched,args", [
    ("constant", (0.3,)), ("cosine_decay", (0.1, 40)),
    ("cosine_decay", (0.2, 40, 0.0)), ("warmup_cosine", (0.1, 8, 40)),
    ("warmup_cosine", (0.05, 0, 10, 0.3))])
def test_schedules_match_the_reference(sched, args):
    jf, tf = getattr(JO, sched)(*args), getattr(TO, sched)(*args)
    for step in range(0, 50, 3):
        got, want = tf(step), jf(step)
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(want)) <= TOL, (sched, step)
    assert float(tf(torch.tensor(12))) == float(tf(12))


def test_client_token_shards_are_bitwise():
    kw = dict(num_clients=5, vocab_size=257, seq_len=16, batch_size=3,
              seed=7)
    want = JTOK.client_token_shards(**kw)
    got = TTOK.client_token_shards(**kw)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    for c in range(5):
        rj, rt = np.random.default_rng(c), np.random.default_rng(c)
        for _ in range(3):
            a, b = got[c].sample(rt), want[c].sample(rj)
            for k in ("tokens", "labels"):
                assert a[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
        it_t, it_j = got[c].batches(), want[c].batches()
        for _ in range(2):
            np.testing.assert_array_equal(next(it_t)["tokens"],
                                          next(it_j)["tokens"])
