"""Shared helpers of the port's parity tests (``test_torch_*.py``): the
same numpy inputs go through the JAX reference (on the CPU) and the
PyTorch port, and the outputs come back as numpy for comparison."""
from __future__ import annotations

import numpy as np
import pytest
import torch

# normal draws: XLA's erf_inv polynomial is ported op for op, but its
# log1p is PyTorch's; the largest gap measured over 8M draws is 3 ulp
NORMAL_MAX_ULP = 3
# exponential draws: -log1p(-u), PyTorch's log1p against XLA's
EXPONENTIAL_MAX_ULP = 1
# gumbel draws: -log(-log u), PyTorch's log against XLA's twice; near
# g = 0 one ulp of the inner log is many ulp of g, so the bound is in
# ulp of max(1, |g|) (measured 1.86 over 10^6 draws)
GUMBEL_MAX_ULP1 = 3
# env tensors (gain, rate, tau, contexts): one ulp of log/log1p moves
# the path loss by an ulp of a ~150 dB number, 3.5e-6 relative in gain
ENV_RTOL = 5e-6


@pytest.fixture(scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread while a module's tests run. The suite
    runs several worker processes at once, and a thread pool sized to
    every core in each of them oversubscribes the machine: small tensor
    ops then wait on spinning threads (a six-worker run of the bandit
    tests took 50x their serial time). The tests' tensors are small and
    gain nothing from the pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_(x) -> np.ndarray:
    """A JAX array, a tensor or a numpy array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor (copied)."""
    a = np.array(np.asarray(x), copy=True)
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def ulp_gap(a, b) -> int:
    """Largest distance in units in the last place between two float32
    arrays of the same signs."""
    a = np.ascontiguousarray(np_(a), np.float32).view(np.int32)
    b = np.ascontiguousarray(np_(b), np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) \
        if a.size else 0


def max_rel(a, b) -> float:
    a, b = np_(a).astype(np.float64), np_(b).astype(np.float64)
    if a.size == 0:
        return 0.0
    return float((np.abs(a - b) / np.maximum(np.abs(a), 1e-30)).max())


def bitwise(a, b) -> bool:
    a, b = np_(a), np_(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        return bool(np.array_equal(a.view(np.int32 if a.itemsize == 4
                                          else np.int64),
                                   b.astype(a.dtype).view(
                                       np.int32 if a.itemsize == 4
                                       else np.int64)))
    return bool(np.array_equal(a, b))


# sweeps: accuracy and loss to the reference's own fused-vs-host
# tolerance; selections and the per-round outputs bitwise
SWEEP_ACC_TOL = 1e-4
SWEEP_POLICIES = ("cocs", "oracle", "random")
SWEEP_FIELDS = ("selections", "utilities", "participants", "explored")


def sweeps_agree(want, got, policies=SWEEP_POLICIES) -> None:
    """A reference ``SweepResult`` against the port's."""
    assert list(got.eval_rounds) == list(want.eval_rounds)
    for p in policies:
        for f in SWEEP_FIELDS:
            w, g = np.asarray(getattr(want, f)[p]), getattr(got, f)[p]
            assert g.shape == w.shape, (p, f)
            assert np.array_equal(w, g), (p, f)
        for f in ("accuracy", "loss"):
            w, g = np.asarray(getattr(want, f)[p]), getattr(got, f)[p]
            assert np.all(np.isfinite(g)), (p, f)
            assert np.abs(w - g).max() <= SWEEP_ACC_TOL, (p, f)
        assert (got.selections[p] >= 0).any(), p


def runs_agree(want, got) -> None:
    """A reference ``RunResult`` against the port's: tier and backend;
    the per-round fields bitwise, in the reference's dtypes; accuracy
    and loss within ``SWEEP_ACC_TOL`` where finite, and non-finite at
    the same places."""
    assert (got.tier, got.env_backend) == (want.tier, want.env_backend)
    for f in SWEEP_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.dtype == w.dtype and np.array_equal(w, g), f
    if want.accuracy is None:
        assert got.accuracy is None
        return
    for f in ("accuracy", "loss"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.shape == w.shape
        assert np.array_equal(np.isfinite(w), np.isfinite(g)), f
        ok = np.isfinite(w)
        assert np.abs(w[ok] - g[ok]).max(initial=0.0) <= SWEEP_ACC_TOL, f


def panel_cells(suite, display, axes=(("corrupt_rate", (0.0, 0.25)),
                                      ("aggregator", ("mean",
                                                      "trimmed_mean",
                                                      "median")))):
    """A fault suite's ``@smoke`` cells for one of its policies, as its
    grid expands them, keyed by their axis values."""
    from dataclasses import replace
    base = replace(suite.resolved_base(smoke=True),
                   policy=dict(suite.policies)[display])
    cells = base.grid(**{k: list(v) for k, v in axes}).expand()
    return {(c.env.faults.corrupt_rate, c.train.aggregator): c
            for c in cells}
