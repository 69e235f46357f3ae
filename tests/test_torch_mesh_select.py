"""The hierarchical sharded selection (``repro_torch.mesh.select``)
against the reference's (``repro.mesh.select``) and against the dense
solvers, bitwise, on the reference's own cases
(``tests/test_mesh_select.py``): shard counts 1, 2, 4 and 8, quantized
ties, N = 1000 with counts that do not divide, zero budgets, an ES no
client may join, all ties. The per-shard segments equal the reference's
(its Pallas tile sort in interpret mode) field for field. Also the new
kernel wrappers' refusals, before anything is built."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: E402,F401
from repro.mesh import hier_flgreedy_assign as j_hier_fl  # noqa: E402
from repro.mesh import hier_greedy_assign as j_hier  # noqa: E402
from repro.mesh import shard_segments as j_shard_segments  # noqa: E402
from repro.policies.solvers import flgreedy_assign as j_fl  # noqa: E402
from repro.policies.solvers import greedy_assign as j_greedy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.budgeted_topk import kernel as K  # noqa: E402
from repro_torch.mesh import (hier_flgreedy_assign,  # noqa: E402
                              hier_greedy_assign, shard_segments)
from repro_torch.policies.solvers import (flgreedy_assign,  # noqa: E402
                                          greedy_assign)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHARD_COUNTS = (1, 2, 4, 8)


def random_instance(rng, n, m, budget=None, quantized=False):
    """The reference test's instance, as numpy float32."""
    values = rng.uniform(0, 1, (n, m))
    if quantized:
        values = np.round(values * 4) / 4.0
    costs = rng.uniform(0.2, 1.0, n)
    if quantized:
        costs = np.round(costs * 4) / 4.0 + 0.25
    budgets = np.full(m, budget if budget is not None
                      else rng.uniform(0.5, 2.0))
    eligible = rng.uniform(size=(n, m)) < 0.7
    return (values.astype(np.float32), costs.astype(np.float32),
            budgets.astype(np.float32), eligible)


def both(v, c, b, e, shards, m=None):
    """(reference hier P2, port hier P2, reference hier P3, port hier P3,
    port dense P2, port dense P3) assignments as numpy."""
    jv, jc, jb, je = (jnp.asarray(a) for a in (v, c, b, e))
    tv, tc, tb, te = (torch.as_tensor(a)[None] for a in (v, c, b, e))
    m = m or v.shape[1]
    return (np.asarray(j_hier(jv, jc, jb, je, num_shards=shards)),
            hier_greedy_assign(tv, tc, tb, te, num_shards=shards)[0].numpy(),
            np.asarray(j_hier_fl(jv, jc, jb, je, num_shards=shards,
                                 num_es=m)),
            hier_flgreedy_assign(tv, tc, tb, te, num_shards=shards,
                                 num_es=m)[0].numpy(),
            greedy_assign(tv, tc, tb, te)[0].numpy(),
            flgreedy_assign(tv, tc, tb, te)[0].numpy())


def assert_all_equal(v, c, b, e, shards):
    jh, th, jf, tf, dense, dense_fl = both(v, c, b, e, shards)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(th, dense)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tf, dense_fl)
    return th


CASES = [(11, 24, 4, False), (12, 17, 3, True), (13, 9, 1, False),
         (14, 24, 2, True), (15, 1, 4, False), (16, 20, 4, True)]


@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("seed,n,m,quantized", CASES)
def test_hier_bitwise_vs_reference_and_dense(seed, n, m, quantized, shards):
    rng = np.random.default_rng(seed)
    assert_all_equal(*random_instance(rng, n, m, quantized=quantized),
                     shards)


@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_hier_bitwise_at_1k(shards):
    """The reference's acceptance-scale pin: N = 1000, M = 8 (3 and 8
    shards do not divide: the rows pad)."""
    rng = np.random.default_rng(7)
    picked = assert_all_equal(*random_instance(rng, 1000, 8, budget=6.0),
                              shards)
    assert (picked >= 0).sum() > 8


@pytest.mark.parametrize("shards", (1, 4))
def test_hier_zero_budget_and_infeasible_es(shards):
    rng = np.random.default_rng(3)
    v, c, _, e = random_instance(rng, 32, 4)
    zero = assert_all_equal(v, c, np.zeros(4, np.float32), e, shards)
    assert (zero >= 0).sum() == 0
    e_dead = e.copy()
    e_dead[:, 2] = False
    hier = assert_all_equal(v, c, np.full(4, 2.0, np.float32), e_dead,
                            shards)
    assert (hier == 2).sum() == 0 and (hier >= 0).sum() > 0


def test_hier_all_ties():
    n, m = 16, 3
    v = np.full((n, m), 0.5, np.float32)
    c = np.full(n, 0.5, np.float32)
    b = np.full(m, 1.5, np.float32)
    e = np.ones((n, m), bool)
    for shards in SHARD_COUNTS:
        assert_all_equal(v, c, b, e, shards)


@pytest.mark.parametrize("shards,tile", [(2, 4), (4, 8), (1, 16)])
def test_shard_segments_equal_the_reference(shards, tile):
    """Each shard's tile-sorted segments with global flat indices and
    global rows: the reference's ``shard_segments`` over its Pallas tile
    sort (interpret mode), field for field."""
    rng = np.random.default_rng(shards + tile)
    v, c, _, e = random_instance(rng, 32, 3, quantized=True)
    want = j_shard_segments(jnp.asarray(v), jnp.asarray(c), jnp.asarray(e),
                            shards, use_kernel=True, tile=tile,
                            interpret=True)
    got = shard_segments(torch.as_tensor(v)[None], torch.as_tensor(c)[None],
                         torch.as_tensor(e)[None], shards, tile)
    for f in got._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)[0].numpy()
        if f in ("density", "cost", "value"):
            np.testing.assert_array_equal(g.view(np.int32),
                                          w.astype(np.float32)
                                          .view(np.int32), err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def test_tile_grid_wrappers_refuse_before_building(monkeypatch):
    """The tile grid's and the segment walk's checks come before any
    build or launch (so they run without nvcc): a tile over the block's
    pairs, CPU tensors, a walk over the block's shared memory."""
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", no_build)
    v = torch.zeros((1, 40, 8))
    c = torch.ones((1, 40))
    e = torch.ones((1, 40, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match=str(K.MAX_PAIRS)):
        K.density_sort_tiles_kernel(v, c, e, 4096)
    with pytest.raises(ValueError, match="expected CUDA"):
        K.density_sort_tiles_kernel(v, c, e, 16)
    d = torch.zeros((1, 3, 256))
    f = torch.zeros((1, 3, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected CUDA"):
        K.segment_walk_kernel(d, f, c, torch.ones((1, 8)), 8)
    big = torch.ones((1, 8_000_000))
    with pytest.raises(ValueError, match="shared memory"):
        K.segment_walk_kernel(d, f, big, torch.ones((1, 8)), 8)
    assert K.tile_for(32) == 512 and K.tile_for(64) == 256
    assert K.tile_shape(1_000_000, 64, 256) == (3907, 16384)
    assert K.walk_smem(1_000_000, 64, 3907) <= K.MAX_SMEM
