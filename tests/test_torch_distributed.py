"""The port's LM-scale HFL steps (``fed/distributed.py``), the tensor
COCS behind the legacy adapter and the ``--arch`` training loop against
the reference's, on the CPU, at qwen2-1.5b's ``reduced()`` (float32, 2
layers), as the reference's ``tests/test_fed.py`` drives its own:

* one ``make_train_step`` from the reference's parameters: loss and every
  new parameter within ``STEP_TOL`` of the reference's jitted step;
* the masking: zero weights leave every parameter bitwise as it was,
  ones move them;
* ``microbatch=2`` against 1 within 1e-5 (gradients accumulated in
  float32 over two slices, then halved);
* ``make_hfl_round``: edges diverge on a round without a sync and are
  equal after the sync round; both rounds within ``STEP_TOL`` of the
  reference's;
* ``remat=True`` against ``remat=False``: bitwise (the checkpointed layer
  runs the same operations again);
* ``make_legacy("cocs")``'s selections bitwise the reference's on the
  same ``sim.round(t)``, and ``lm_rounds`` (the launcher's loop) for 3
  rounds against the reference's pieces (``make_legacy``, ``sim.round``,
  the shards, its ``make_train_step``): selections bitwise, losses
  within 1e-4;
* ``make_concrete_batch`` and ``supports_shape``.

STEP_TOL: parameters are O(1) and one step moves them by lr x gradient
(lr 0.1, gradients below 0.5, the gradients within 2e-5 of their leaf's
scale, test_torch_train_loss.py): 1e-5 absolute (measured 3.5e-8).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import np_, one_torch_thread  # noqa: E402,F401
from repro import envs as JE  # noqa: E402
from repro import policies as JP  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.paper_hfl import MNIST_CONVEX  # noqa: E402
from repro.data.tokens import client_token_shards  # noqa: E402
from repro.fed import distributed as JD  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import envs as TE  # noqa: E402
from repro_torch import policies as TP  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.fed import distributed as TD  # noqa: E402
from repro_torch.launch.train import lm_rounds  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "qwen2-1.5b"
STEP_TOL = 1e-5
LR = 0.1


@pytest.fixture(scope="module")
def setup():
    jc, tc = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jax.tree.map(np.asarray, JR.init_params(jc, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, tc.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    return jc, tc, jp, batch


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _max_gap(got, want) -> float:
    return max(float(np.abs(np_(a) - np.asarray(b, np.float32)).max())
               for a, b in zip(_leaves(got), _leaves(want)))


def test_train_step_matches_the_reference(setup):
    jc, tc, jp, batch = setup
    w = np.array([1.0, 0.5, 0.0, 1.0], np.float32)
    want_p, want_l = jax.jit(JD.make_train_step(jc, lr=LR))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(w))
    got_p, got_l = TD.make_train_step(tc, lr=LR)(
        lm_params_from_jax(jp), _tb(batch), torch.as_tensor(w))
    assert abs(float(got_l) - float(want_l)) <= 1e-6 * abs(float(want_l))
    assert _max_gap(got_p, want_p) <= STEP_TOL


def test_zero_weights_freeze_the_params(setup):
    _, tc, jp, batch = setup
    params = lm_params_from_jax(jp)
    step = TD.make_train_step(tc, lr=LR)
    p0, _ = step(params, _tb(batch), torch.zeros(4))
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(p0), _leaves(params)))
    p1, _ = step(params, _tb(batch), torch.ones(4))
    assert any(not torch.equal(a, b)
               for a, b in zip(_leaves(p1), _leaves(params)))


def test_microbatch_equals_one_slice(setup):
    """With equal weights in both halves (the reference's case; a
    weighted mean of halves is not the whole batch's weighted mean
    otherwise)."""
    _, tc, jp, batch = setup
    params = lm_params_from_jax(jp)
    w = torch.ones(4)
    p1, l1 = TD.make_train_step(tc, lr=LR)(params, _tb(batch), w)
    p2, l2 = TD.make_train_step(tc, lr=LR, microbatch=2)(params, _tb(batch),
                                                         w)
    assert abs(float(l1) - float(l2)) <= 1e-5
    assert _max_gap(p2, p1) <= 1e-5


def test_hfl_round_syncs_every_t_es(setup):
    jc, tc, jp, _ = setup
    n_edge = 2
    rng = np.random.default_rng(9)
    sb = {k: rng.integers(0, tc.vocab_size, (n_edge, 2, 16)).astype(np.int32)
          for k in ("tokens", "labels")}
    w = np.ones((n_edge, 2), np.float32)
    jrnd = jax.jit(JD.make_hfl_round(jc, n_edge=n_edge, t_es=2, lr=LR))
    trnd = TD.make_hfl_round(tc, n_edge=n_edge, t_es=2, lr=LR)
    jep = JD.stack_edge_params(jp, n_edge)
    tep = TD.stack_edge_params(lm_params_from_jax(jp), n_edge)
    jsb = {k: jnp.asarray(v) for k, v in sb.items()}
    for step in (0, 1):
        jep, jl = jrnd(jep, jsb, jnp.asarray(w), jnp.asarray(step))
        tep, tl = trnd(tep, _tb(sb), torch.as_tensor(w), step)
        assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
        assert _max_gap(tep, jep) <= STEP_TOL
        equal = all(torch.equal(a[0], a[1]) for a in _leaves(tep))
        assert equal == (step == 1), step


def test_remat_equals_no_remat(setup):
    _, tc, jp, batch = setup
    params = lm_params_from_jax(jp)
    w = torch.tensor([1.0, 0.0, 1.0, 1.0])
    pa, la = TD.make_train_step(tc, lr=LR)(params, _tb(batch), w)
    pb, lb = TD.make_train_step(tc, lr=LR, remat=True)(params, _tb(batch), w)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(pa), _leaves(pb)))


def test_legacy_cocs_selects_as_the_reference():
    cfg = dataclasses.replace(MNIST_CONVEX, num_clients=12)
    horizon = 30
    jpol = JP.make_legacy("cocs", JP.PolicySpec.from_experiment(cfg, horizon),
                          seed=0, h_t=cfg.h_t)
    tpol = TP.make_legacy("cocs", TP.PolicySpec.from_experiment(cfg, horizon),
                          seed=0, h_t=cfg.h_t, device="cpu")
    jsim = JE.make("paper", cfg).make_sim(0)
    tsim = TE.make("paper", cfg).make_sim(0)
    explored = 0
    for t in range(horizon):
        jrd, trd = jsim.round(t), tsim.round(t)
        want = jpol.select(jrd)
        jpol.update(jrd, want)
        got = tpol.step(trd)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        assert tpol.last_explored == jpol.last_explored
        explored += tpol.last_explored
    assert explored > 0
    if not torch.cuda.is_available():    # the default device is CUDA
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.make_legacy("cocs", TP.PolicySpec.from_experiment(cfg, 5))


def test_lm_rounds_match_the_reference_loop():
    clients, rounds, seq, b, seed = 6, 3, 16, 2, 0
    jc, tc = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp0 = JR.init_params(jc, jax.random.PRNGKey(seed))
    _, got = lm_rounds(tc, lm_params_from_jax(jax.tree.map(np.asarray, jp0)),
                       clients=clients, rounds=rounds, seq_len=seq, batch=b,
                       lr=LR, seed=seed, device="cpu", verbose=False)
    # the reference's run_lm, its pieces with the same arguments
    exp_n = dataclasses.replace(MNIST_CONVEX, num_clients=clients)
    policy = JP.make_legacy("cocs", JP.PolicySpec.from_experiment(
        exp_n, rounds), seed=seed, h_t=MNIST_CONVEX.h_t)
    sim = JE.make("paper", exp_n).make_sim(seed)
    shards = client_token_shards(clients, jc.vocab_size, seq, b, seed=seed)
    rngs = [np.random.default_rng(seed + c) for c in range(clients)]
    step = jax.jit(JD.make_train_step(jc, lr=LR))
    params = jp0
    steps = 0
    for t in range(rounds):
        rd = sim.round(t)
        assign = policy.select(rd)
        policy.update(rd, assign)
        sel = np.nonzero(assign >= 0)[0]
        np.testing.assert_array_equal(got[t][0], sel)
        losses = []
        for c in sel:
            batch = shards[c].sample(rngs[c])
            w = jnp.full((b,), float(rd.outcomes[c, assign[c]]))
            params, loss = step(params, jax.tree.map(jnp.asarray, batch), w)
            losses.append(float(loss))
        np.testing.assert_allclose(got[t][1], losses, rtol=0, atol=1e-4)
        steps += len(sel)
    assert steps > 0


def test_concrete_batch_and_supported_shapes():
    shape = InputShape("s", 16, 2, "train")
    for arch in ARCH_IDS:
        tc = get_config(arch).reduced()
        jc = jax_config(arch).reduced()
        got = R.make_concrete_batch(tc, shape, seed=3, device="cpu")
        want = JR.make_concrete_batch(jc, shape, jax.random.PRNGKey(3))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape
            assert str(got[k].dtype).split(".")[-1] == str(v.dtype)
        assert int(got["tokens"].max()) < tc.vocab_size
        again = R.make_concrete_batch(tc, shape, seed=3, device="cpu")
        assert all(torch.equal(got[k], again[k]) for k in got)
        for s in INPUT_SHAPES.values():
            assert R.supports_shape(tc, s) == JR.supports_shape(jc, s)
