"""The port's context_pairwise plain version against the reference's
oracle and its Pallas kernel (interpret mode), on the CPU.

The reference runs the oracle under ``jit`` inside its simulator, where
XLA contracts and folds its arithmetic (``repro_torch.core.fmath``); the
port follows that execution, so the oracle is held here under ``jit``
too. The distance is then bitwise; the transcendental stages (PyTorch's
``log``/``log1p``/``pow`` against XLA's) agree to ``ENV_RTOL``."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import ENV_RTOL, bitwise, max_rel, t_  # noqa: E402
from repro.core.network import _dbm_to_watt, es_positions  # noqa: E402
from repro.kernels.context_pairwise.kernel import \
    context_pairwise_kernel as jax_kernel  # noqa: E402
from repro.kernels.context_pairwise.ref import \
    pairwise_context_ref as jax_ref  # noqa: E402
from repro_torch.kernels.context_pairwise.ops import \
    pairwise_context  # noqa: E402
from repro_torch.kernels.context_pairwise.ref import \
    pairwise_context_ref  # noqa: E402

KW = dict(tx_w=_dbm_to_watt(23.0), noise_psd_w=_dbm_to_watt(-174.0),
          update_bits=0.18e6, workload=2.41e6)


def _inputs(n, m, seed, kind="random"):
    rng = np.random.default_rng(seed)
    es = es_positions(m).astype(np.float32)
    pos = rng.uniform(-3.5, 3.5, (n, 2)).astype(np.float32)
    bw = rng.uniform(0.3e6, 1e6, n).astype(np.float32)
    comp = rng.uniform(2e6, 4e6, n).astype(np.float32)
    fdt = rng.exponential(size=(n, m)).astype(np.float32)
    fut = rng.exponential(size=(n, m)).astype(np.float32)
    if kind == "near":           # below the 0.01 km path-loss floor
        pos = (es[rng.integers(0, m, n)]
               + rng.uniform(-0.006, 0.006, (n, 2))).astype(np.float32)
    elif kind == "weak":         # deep fades: snr far below 1
        fdt = (fdt * 1e-6).astype(np.float32)
        fut = (fut * 1e-7).astype(np.float32)
    return pos, es, bw, comp, fdt, fut


def _check(want, got):
    assert bitwise(want.dist, got.dist)
    for f in ("gain", "rate", "tau"):
        assert max_rel(getattr(want, f), getattr(got, f)) <= ENV_RTOL, f


@pytest.mark.parametrize("kind", ["random", "near", "weak"])
@pytest.mark.parametrize("n,m,seed", [(300, 12, 0), (50, 3, 1), (7, 1, 2)])
def test_ref_matches_reference_oracle(n, m, seed, kind):
    args = _inputs(n, m, seed, kind)
    want = jax.jit(lambda *a: jax_ref(*a, **KW))(*map(jnp.asarray, args))
    got = pairwise_context_ref(*map(t_, args), **KW)
    _check(want, got)


def test_ref_matches_reference_pallas_kernel_interpret():
    args = _inputs(37, 3, 5)
    want = jax_kernel(*map(jnp.asarray, args), **KW, tile=16,
                      interpret=True)
    got = pairwise_context_ref(*map(t_, args), **KW)
    _check(want, got)


def test_cpu_wrapper_takes_plain_version_with_seed_axis():
    per_seed = [_inputs(20, 4, s) for s in (0, 1)]
    stacked = [np.stack([a[i] for a in per_seed]) if i != 1 else
               per_seed[0][1] for i in range(6)]
    got = pairwise_context(*map(t_, stacked), **KW)
    assert got.tau.shape == (2, 20, 4)
    for s in range(2):
        one = pairwise_context_ref(*map(t_, per_seed[s]), **KW)
        for f in one._fields:
            assert torch.equal(getattr(one, f), getattr(got, f)[s])
