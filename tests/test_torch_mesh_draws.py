"""A client shard's draws and the sharded pack.

``shard_round_draws``/``shard_fault_draws`` at 2 and 4 shards are
bitwise rows of the port's dense draws, and rows of the reference's
dense ``round_draws``/``fault_draws`` within the draw ladder (uniforms
bitwise, normals within ``NORMAL_MAX_ULP``, exponentials within
``EXPONENTIAL_MAX_ULP``). The reference's own ``shard_*`` functions are
not the oracle: on jax 0.9.0 they are not rows of its dense stream
(ROADMAP, reference caveat R1). ``pack_assignment_sharded``'s two halves,
each shard's ``pack_rows`` at its prefix and ``merge_packs``, give the
dense ``pack_assignment`` bit for bit."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (EXPONENTIAL_MAX_ULP,  # noqa: E402,F401
                           NORMAL_MAX_ULP, bitwise, one_torch_thread,
                           ulp_gap)
from repro.sim import draws as jdraws  # noqa: E402
from repro_torch.experiment.packing import (es_counts,  # noqa: E402
                                            merge_packs, pack_assignment,
                                            pack_capacity, pack_rows)
from repro_torch.sim import draws as tdraws  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, M, K_MC = 64, 4, 3
NORMAL = ("move", "bw_n", "comp_n")
EXPONENTIAL = ("fad_dt", "fad_ut", "mc_dt", "mc_ut")


def _rows(a, f, lo, n_local):
    return a[:, lo:lo + n_local] if f.startswith("mc_") else \
        a[lo:lo + n_local]


@pytest.mark.parametrize("t", (0, 7))
@pytest.mark.parametrize("shards", (2, 4))
def test_shard_round_draws_are_dense_rows(shards, t):
    seed = 5
    dense = tdraws.round_draws(seed, t, N, M, K_MC)
    ref = jax.jit(jdraws.round_draws, static_argnums=(2, 3, 4))(
        jnp.uint32(seed), jnp.int32(t), N, M, K_MC)
    n_local = N // shards
    for s in range(shards):
        lo = s * n_local
        part = tdraws.shard_round_draws(seed, t, N, M, K_MC, lo, n_local)
        for f in part._fields:
            got = getattr(part, f)
            assert torch.equal(got, _rows(getattr(dense, f), f, lo,
                                          n_local)), f
            want = _rows(np.asarray(getattr(ref, f)), f, lo, n_local)
            bound = NORMAL_MAX_ULP if f in NORMAL else EXPONENTIAL_MAX_ULP
            assert ulp_gap(want, got) <= bound, f
    # a seed axis and the analytic mode (no Monte-Carlo draw)
    seeds = torch.tensor([3, 9])
    both = tdraws.round_draws(seeds, t, N, M, 0)
    part = tdraws.shard_round_draws(seeds, t, N, M, 0, N - n_local, n_local)
    for f in part._fields:
        want = getattr(both, f)
        want = want[:, :, N - n_local:] if f.startswith("mc_") \
            else want[:, N - n_local:]
        assert torch.equal(getattr(part, f), want), f


@pytest.mark.parametrize("t", (0, 7))
@pytest.mark.parametrize("shards", (2, 4))
def test_shard_fault_draws_are_dense_rows(shards, t):
    seed = 11
    dense = tdraws.fault_draws(seed, t, N, M)
    ref = jax.jit(jdraws.fault_draws, static_argnums=(2, 3))(
        jnp.uint32(seed), jnp.int32(t), N, M)
    n_local = N // shards
    for s in range(shards):
        lo = s * n_local
        part = tdraws.shard_fault_draws(seed, t, N, M, lo, n_local)
        for f in part._fields:
            got, d = getattr(part, f), getattr(dense, f)
            want = np.asarray(getattr(ref, f))
            if f != "out_u":               # the per-ES stream is whole
                d, want = d[lo:lo + n_local], want[lo:lo + n_local]
            assert torch.equal(got, d), f
            if f == "strag_e":
                assert ulp_gap(want, got) <= EXPONENTIAL_MAX_ULP
            else:
                assert bitwise(want, got), f
    # only the streams asked for are drawn
    one = tdraws.shard_fault_draws(seed, t, N, M, 0, n_local,
                                   fields=("drop_u",))
    assert one.corr_u is None and torch.equal(one.drop_u,
                                              dense.drop_u[:n_local])


@pytest.mark.parametrize("kind", ("random", "crowded", "empty"))
@pytest.mark.parametrize("shards", (1, 2, 4, 8))
def test_sharded_pack_is_the_dense_pack(shards, kind):
    rng = np.random.default_rng(shards)
    s, n, m = 2, 40, 5
    a = rng.integers(-1, m, (s, n))
    if kind == "crowded":
        a[:, ::2] = 3
    elif kind == "empty":
        a[:] = -1
    a = torch.as_tensor(a, dtype=torch.int32)
    outcomes = torch.as_tensor(rng.random((s, n, m)) < 0.6,
                               dtype=torch.float32)
    latency = torch.as_tensor(rng.exponential(size=(s, n, m)),
                              dtype=torch.float32)
    cap = pack_capacity(es_counts(a, m), None)
    dense = pack_assignment(a, outcomes, latency, m, cap)
    nl = n // shards
    rows = lambda x, i: x[:, i * nl:(i + 1) * nl]
    counts = torch.stack([es_counts(rows(a, i), m) for i in range(shards)])
    assert pack_capacity(counts.sum(dim=0), None) == cap
    blocks = torch.stack([pack_rows(rows(a, i), rows(outcomes, i),
                                    rows(latency, i), m, cap,
                                    counts[:i].sum(dim=0), i * nl)
                          for i in range(shards)])
    for want, got in zip(dense, merge_packs(blocks)):
        assert want.dtype == got.dtype and torch.equal(want, got)
    with pytest.raises(ValueError, match="slots_per_es"):
        pack_capacity(counts.sum(dim=0) + cap + 1, cap)
