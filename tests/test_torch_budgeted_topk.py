"""The port's P2 density greedy and its sorted segments against the
reference: ``pair_density``, the sorted candidate layouts and
``greedy_assign``, on identical float32 inputs (bitwise)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import bitwise, np_, t_  # noqa: E402
from repro.kernels.budgeted_topk.kernel import \
    density_sort_kernel as jax_kernel  # noqa: E402
from repro.kernels.budgeted_topk.ref import (  # noqa: E402
    pair_density as jax_density, sorted_candidates_ref as jax_sorted)
from repro.policies.solvers import greedy_assign as jax_greedy  # noqa: E402
from repro_torch.kernels.budgeted_topk.ops import (  # noqa: E402
    budgeted_topk, sorted_candidates)
from repro_torch.kernels.budgeted_topk.ref import (  # noqa: E402
    density_sort_ref, pair_density)
from repro_torch.policies.solvers import greedy_assign  # noqa: E402

KINDS = ["random", "ties", "zero-budget", "infeasible", "tight"]


def _inputs(n, m, seed, kind):
    rng = np.random.default_rng(seed)
    v = rng.random((n, m)).astype(np.float32)
    c = rng.uniform(0.3, 4.0, n).astype(np.float32)
    e = rng.random((n, m)) < 0.5
    b = np.full(m, 3.5, np.float32)
    if kind == "ties":            # equal densities: the index breaks ties
        v[:] = 0.5
        c[:] = 1.0
        e[:] = True
    elif kind == "zero-budget":
        b[::2] = 0.0
    elif kind == "infeasible":    # nothing eligible
        e[:] = False
    elif kind == "tight":         # costs at the budget edge
        c[:] = 3.5
        c[::4] = 0.0
    return v, c, e, b


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,seed", [(50, 3, 0), (37, 5, 1), (130, 12, 2)])
def test_density_and_single_segment(n, m, seed, kind):
    v, c, e, _ = _inputs(n, m, seed, kind)
    assert bitwise(jax_density(jnp.asarray(v), jnp.asarray(c),
                               jnp.asarray(e)),
                   pair_density(t_(v), t_(c), t_(e)))
    # one tile of all N clients is the reference oracle's single
    # segment, padded with (-inf, -1) to a power of two
    jd, ji = jax_sorted(jnp.asarray(v), jnp.asarray(c), jnp.asarray(e))
    td, ti = density_sort_ref(t_(v)[None], t_(c)[None], t_(e)[None], n)
    assert bitwise(jd, td[0, :, :n * m]) and bitwise(ji, ti[0, :, :n * m])
    assert (ti[0, :, n * m:] == -1).all()


@pytest.mark.parametrize("kind", ["random", "ties", "infeasible"])
@pytest.mark.parametrize("n,m,tile", [(37, 3, 16), (64, 5, 32), (9, 2, 8)])
def test_tiled_layout_matches_reference_pallas_kernel(n, m, tile, kind):
    """The plain version of the CUDA density sort has the layout of the
    reference's Pallas kernel (interpret mode), bit for bit."""
    v, c, e, _ = _inputs(n, m, n + m, kind)
    jd, ji = jax_kernel(jnp.asarray(v), jnp.asarray(c), jnp.asarray(e),
                        tile=tile, interpret=True)
    td, ti = density_sort_ref(t_(v)[None], t_(c)[None], t_(e)[None], tile)
    assert bitwise(jd, td[0]) and bitwise(ji, ti[0])
    # and the CPU wrapper routes to it
    wd, wi = sorted_candidates(t_(v)[None], t_(c)[None], t_(e)[None], tile)
    assert torch.equal(wd, td) and torch.equal(wi, ti)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,seed", [(50, 3, 0), (37, 5, 1), (300, 12, 2)])
def test_greedy_assign_matches_reference(n, m, seed, kind):
    v, c, e, b = _inputs(n, m, seed, kind)
    want = np.asarray(jax_greedy(jnp.asarray(v), jnp.asarray(c),
                                 jnp.asarray(b), jnp.asarray(e),
                                 use_kernel=False))
    got = greedy_assign(t_(v)[None], t_(c)[None], t_(b), t_(e)[None])
    assert got.dtype == torch.int32
    assert np.array_equal(want, np_(got)[0])
    if kind == "infeasible":
        assert (np_(got) == -1).all()


def test_seed_batch_walk_equals_per_seed_walks():
    """Seeds whose walks end at different iterations stay independent."""
    ins = [_inputs(40, 4, s, k) for s, k in
           ((0, "random"), (1, "infeasible"), (2, "tight"))]
    stack = lambda i: torch.stack([t_(x[i]) for x in ins])
    got = budgeted_topk(stack(0), stack(1), stack(3), stack(2), tile=16)
    for s, (v, c, e, b) in enumerate(ins):
        one = budgeted_topk(t_(v)[None], t_(c)[None], t_(b)[None],
                            t_(e)[None], tile=16)
        assert torch.equal(got[s], one[0])
