"""The port's checkpoint store (``repro_torch.checkpoint``) and the
resilient runner's carry helpers: every dtype the carries hold
round-trips with its shape and dtype (bool, int32, int64 (Random's key
state), float32, float64, bfloat16), NamedTuple states and the Oracle's
``None`` state come back in their template's structure, the newest
checkpoint is picked by step number, an empty, garbage, truncated or
foreign file raises a ``ValueError`` naming it, and a write leaves no
temporary file behind. The leaf names of the health guard are the ones
``jax.tree_util.keystr`` gives the reference's carry."""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (latest_checkpoint, restore_pytree,
                                    save_pytree)
from repro_torch.experiment.sweep import _leaves, _like
from repro_torch.policies.baselines import KeyState
from repro_torch.policies.cocs import COCSState

DTYPES = {
    "bool": torch.tensor([[True, False, True]]),
    "int32": torch.arange(12, dtype=torch.int32).reshape(3, 4) - 5,
    "int64": torch.tensor([[0, 2 ** 40 + 7], [0, -3]], dtype=torch.int64),
    "float32": torch.linspace(-1, 1, 28).reshape(4, 7),
    "float64": torch.tensor([1e-300, -2.5, np.pi], dtype=torch.float64),
    "bfloat16": torch.tensor([[0.1, -3.0], [1e30, 7.0]],
                             dtype=torch.bfloat16),
}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_dtype_round_trip(tmp_path, name):
    a = DTYPES[name]
    save_pytree(str(tmp_path), {"leaf": a, "nested": [a, {"x": a}]}, step=1)
    back = restore_pytree(latest_checkpoint(str(tmp_path)))
    for b in (back["leaf"], back["nested"][0], back["nested"][1]["x"]):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(b, a)


def test_numpy_leaves_and_scalars_round_trip(tmp_path):
    tree = {"np": np.arange(5, dtype=np.int64), "i": 3, "s": "run",
            "f": 0.5, "none": None}
    back = restore_pytree(save_pytree(str(tmp_path / "t.pt"), tree))
    assert torch.equal(back["np"], torch.arange(5))
    assert (back["i"], back["s"], back["f"], back["none"]) == (3, "run",
                                                               0.5, None)


@pytest.mark.parametrize("state", ["cocs", "random", "oracle"])
def test_policy_state_round_trip_in_template_structure(tmp_path, state):
    """COCS's NamedTuple of int32 counters and float32 estimates,
    Random's int64 key and the Oracle's ``None`` come back through
    ``_like`` as the template's own types, bitwise."""
    g = torch.Generator().manual_seed(0)
    pstate = {"cocs": COCSState(
        torch.randint(0, 9, (2, 5, 3, 2, 2), dtype=torch.int32,
                      generator=g),
        torch.rand((2, 5, 3, 2, 2), generator=g)),
        "random": KeyState(torch.tensor([[0, 7], [0, 8]])),
        "oracle": None}[state]
    carry = {"pstate": pstate,
             "edge": {"w": torch.rand((2, 3, 7, 10), generator=g),
                      "b": torch.zeros((2, 3, 10))}}
    save_pytree(str(tmp_path), carry, step=2)
    raw = restore_pytree(latest_checkpoint(str(tmp_path)))
    if state != "oracle":
        assert isinstance(raw["pstate"], list)   # NamedTuples -> lists
    back = {k: _like(carry[k], raw[k]) for k in carry}
    assert type(back["pstate"]) is type(pstate)
    assert list(back["edge"]) == list(carry["edge"])
    want, got = list(_leaves(carry)), list(_leaves(back))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_like_refuses_another_carry(tmp_path):
    carry = {"w": torch.zeros((2, 3)), "k": torch.zeros(2, dtype=torch.int64)}
    with pytest.raises(ValueError, match="leaves"):
        _like(carry, {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="expected"):
        _like(carry, {"w": torch.zeros((2, 4)),
                      "k": torch.zeros(2, dtype=torch.int64)})
    with pytest.raises(ValueError, match="expected"):
        _like(carry, {"w": torch.zeros((2, 3), dtype=torch.float64),
                      "k": torch.zeros(2, dtype=torch.int64)})


def test_latest_checkpoint_numeric_ordering(tmp_path):
    """12 steps plus a hand-written unpadded ``ckpt_9``: the newest is
    picked by step number (lexically ``ckpt_9`` sorts last)."""
    d = str(tmp_path)
    for step in range(1, 13):
        save_pytree(d, {"x": torch.full((2,), step)}, step=step)
    assert latest_checkpoint(d).endswith("ckpt_00000012.pt")
    with open(os.path.join(d, "ckpt_00000012.pt"), "rb") as f:
        payload = f.read()
    with open(os.path.join(d, "ckpt_9.pt"), "wb") as f:
        f.write(payload)
    assert latest_checkpoint(d).endswith("ckpt_00000012.pt")
    assert torch.equal(restore_pytree(latest_checkpoint(d))["x"],
                       torch.full((2,), 12))
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_write_is_atomic_and_leaves_no_temp_file(tmp_path):
    d = str(tmp_path)
    path = save_pytree(d, {"w": torch.ones(3)}, step=1)
    save_pytree(d, {"w": torch.full((3,), 2.0)}, step=1)     # overwrite
    assert os.listdir(d) == [os.path.basename(path)]
    assert torch.equal(restore_pytree(path)["w"], torch.full((3,), 2.0))
    with pytest.raises(TypeError, match="checkpoint"):
        save_pytree(d, {"w": object()}, step=2)
    assert os.listdir(d) == [os.path.basename(path)]


def test_restore_empty_file_raises(tmp_path):
    p = str(tmp_path / "ckpt_00000001.pt")
    open(p, "wb").close()
    with pytest.raises(ValueError, match="empty") as e:
        restore_pytree(p)
    assert p in str(e.value)


def test_restore_garbage_raises(tmp_path):
    p = str(tmp_path / "ckpt_00000001.pt")
    with open(p, "wb") as f:
        f.write(b"\xc1 this is not a checkpoint \xc1")
    with pytest.raises(ValueError, match="corrupt or truncated") as e:
        restore_pytree(p)
    assert p in str(e.value)


def test_restore_truncated_raises(tmp_path):
    d = str(tmp_path)
    save_pytree(d, {"w": torch.arange(4096, dtype=torch.float32)}, step=1)
    p = latest_checkpoint(d)
    with open(p, "rb") as f:
        payload = f.read()
    with open(p, "wb") as f:
        f.write(payload[: len(payload) // 2])
    with pytest.raises(ValueError, match="corrupt or truncated") as e:
        restore_pytree(p)
    assert p in str(e.value)


def test_restore_foreign_torch_file_raises(tmp_path):
    """A ``torch.save`` file that is not a checkpoint of the store."""
    p = str(tmp_path / "ckpt_00000001.pt")
    torch.save({"w": torch.ones(2)}, p)
    with pytest.raises(ValueError, match="not a repro_torch checkpoint"):
        restore_pytree(p)


def test_leaf_names_are_the_references(tmp_path):
    """``_leaves`` walks a tier-4 carry in the reference's pytree order
    and names each leaf as ``jax.tree_util.keystr`` does."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.policies.cocs import COCSState as JState

    def carry(mod, state):
        z = mod.zeros((2, 3))
        return {"pstate": state(z, z), "pos": z,
                "edge": {"w": z, "b": z}}
    flat = jax.tree_util.tree_flatten_with_path(carry(jnp, JState))[0]
    want = [jax.tree_util.keystr(p) for p, _ in flat]
    got = [p for p, _ in _leaves(carry(torch, COCSState))]
    assert got == want
    assert "['edge']['w']" in got and "['pstate'].p_hat" in got


def test_cnn_kill_and_resume_bitwise(tmp_path):
    """The CNN (P3, ``cifar_small``) killed after its first interval and
    resumed equals its uninterrupted run bitwise on the CPU. On the card
    two CNN runs differ under cuDNN's default algorithms (``chip_smoke.py``
    phase 18 gates the resume there under its deterministic ones), so
    this is the CNN's resume gate. One local epoch, a budget of 10 and
    small shards keep it to a few seconds: a resume reads none of
    them."""
    import dataclasses

    from repro_torch.configs.paper_hfl import CIFAR10_NONCONVEX
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.experiment.sweep import (SimulatedKill,
                                              sweep_experiments)
    from repro_torch.sim import spec as simspec
    env = simspec.make("paper", dataclasses.replace(
        CIFAR10_NONCONVEX, lr=0.005, local_epochs=1, budget=10.0))
    data = FederatedDataset.synthetic(50, kind="cifar_small",
                                      samples_per_client=16,
                                      test_samples=100)
    kw = dict(seeds=(0,), horizon=2, eval_every=1, model_kind="cnn",
              batches_per_epoch=1, data=data, device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = sweep_experiments(("cocs",), env, **kw)
        ck = str(tmp_path / "ck")
        with pytest.raises(SimulatedKill):
            sweep_experiments(("cocs",), env, checkpoint_dir=ck,
                              stop_after_blocks=1, **kw)
        resumed = sweep_experiments(("cocs",), env, checkpoint_dir=ck,
                                    resume=True, **kw)
    finally:
        torch.set_num_threads(n)
    for f in ("selections", "utilities", "participants", "explored",
              "accuracy", "loss", "train_loss"):
        a, b = getattr(plain, f)["cocs"], getattr(resumed, f)["cocs"]
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.isfinite(plain.loss["cocs"]).all()
