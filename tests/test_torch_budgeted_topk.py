"""The port's P2 density greedy and its sorted segments against the
reference: ``pair_density``, the sorted candidate layouts and
``greedy_assign``, on identical float32 inputs (bitwise). Also the CUDA
kernel's algorithm (one pass over one global sort, 32 candidates at a
time, restarting after a negative cost) mirrored in numpy and held
bitwise against the reference's assignments and budgets left, and the
kernel wrapper's checks, which raise on the CPU before any build."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import bitwise, np_, t_  # noqa: E402
from repro.kernels.budgeted_topk.kernel import \
    density_sort_kernel as jax_kernel  # noqa: E402
from repro.kernels.budgeted_topk.ops import (  # noqa: E402
    build_segments as jax_segments, greedy_walk as jax_walk)
from repro.kernels.budgeted_topk.ref import (  # noqa: E402
    pair_density as jax_density, sorted_candidates_ref as jax_sorted)
from repro.policies.solvers import greedy_assign as jax_greedy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.budgeted_topk.kernel import (  # noqa: E402
    MAX_PAIRS, budgeted_topk_kernel)
from repro_torch.kernels.budgeted_topk.ops import (  # noqa: E402
    budgeted_topk, budgeted_topk_walk, sorted_candidates)
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
    elif kind == "negative-cost":  # picks that raise a budget, some ES
        c[::5] = -rng.uniform(0.5, 2.0, c[::5].shape)  # starting below 0
        c[1::7] = 0.0
        b[::3] = -1.0
    elif kind == "zero-cost":
        c[::3] = 0.0
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


# -- the CUDA kernel's algorithm, mirrored on the CPU ------------------------

WALK_KINDS = KINDS + ["negative-cost", "zero-cost"]
WALK_CASES = [(n, m, seed, kind) for kind in WALK_KINDS
              for (n, m, seed) in ((50, 3, 0), (37, 5, 1), (300, 12, 2),
                                   (1, 1, 3))] + [(1000, 12, 4, "random")]
EPS = np.float32(1e-12)


def _kernel_mirror(v, c, e, b, restart=True):
    """``csrc/budgeted_topk.cu`` for one seed in numpy float32: keep the
    pairs of density > 0, sort their keys (density bits << 32 | client
    << 14 | es) once, descending, and pass over them 32 at a time
    (``_group``). A pick that raised its ES's budget (a negative cost)
    restarts the pass from the head; ``restart=False`` leaves that out.
    Returns (assign (N,) int32, remaining (M,) float32)."""
    n, m = v.shape
    with np.errstate(invalid="ignore", divide="ignore"):
        den = v / np.maximum(c, EPS)[:, None]      # a NaN cost stays NaN
    ci, ei = np.nonzero(e & (den > 0))
    key = ((den[ci, ei].view(np.uint32).astype(np.uint64) << np.uint64(32))
           | (ci.astype(np.uint64) << np.uint64(14)) | ei.astype(np.uint64))
    order = np.argsort(key)[::-1]                  # keys are unique
    cl, es = ci[order], ei[order]
    assign = np.full(n, -1, np.int32)
    rem = b.astype(np.float32).copy()
    pos = 0
    while pos < len(cl):
        lanes = [(cl[q], es[q]) for q in range(pos, min(pos + 32, len(cl)))]
        again = _group(lanes, c, assign, rem, restart)
        pos = 0 if again else pos + 32
    return assign, rem


def _group(lanes, c, assign, rem, restart):
    """One group of 32 sorted candidates (client, es), as the kernel's
    warp resolves it; updates ``assign`` and ``rem``, returns whether
    the pass restarts. With a negative cost in the group: the first
    feasible lane picks, the lanes after it are tested again, and a pick
    that raised a budget ends the group. Otherwise in rounds: a lane
    feasible at the start decides once every feasible lane before it
    with its ES or its client has decided, and each chain's budget falls
    by its picks in lane order."""
    feasible = lambda q: (assign[lanes[q][0]] < 0
                          and c[lanes[q][0]] <= rem[lanes[q][1]] + EPS)
    if restart and any(c[cl] < 0 for cl, _ in lanes):
        pending = list(range(len(lanes)))
        while pending:
            hit = [q for q in pending if feasible(q)]
            if not hit:
                return False
            cl, j = lanes[hit[0]]
            assign[cl] = j
            left = rem[j] + (-c[cl])
            grew = left > rem[j]
            rem[j] = left
            if grew:
                return True
            pending = [q for q in pending if q > hit[0]]
        return False
    room = [rem[j] for _, j in lanes]
    open_ = {q for q in range(len(lanes)) if feasible(q)}
    took_all = set()
    dep = lambda k, q: (lanes[k][0] == lanes[q][0]
                        or lanes[k][1] == lanes[q][1])
    while open_:
        ready = {q for q in open_ if not any(k < q and dep(k, q)
                                             for k in open_)}
        take = {q for q in ready
                if not any(k < q and lanes[k][0] == lanes[q][0]
                           for k in took_all)
                and c[lanes[q][0]] <= room[q] + EPS}
        open_ -= ready
        took_all |= take
        left = {lanes[q][1]: room[q] + (-c[lanes[q][0]]) for q in take}
        room = [left.get(j, r) for (_, j), r in zip(lanes, room)]
    for q in took_all:
        cl, j = lanes[q]
        assign[cl] = j
        rem[j] = room[q]
    return False


@functools.lru_cache(maxsize=None)
def _jax_walk_fn(n, m):
    return jax.jit(lambda v, c, e, b: jax_walk(
        jax_segments(v, c, e), b, num_es=m, num_clients=n))


def _reference(v, c, e, b):
    """The reference's assignment (``greedy_assign``, the legacy argmax
    loop) and its walk's budgets left (``greedy_walk``)."""
    n, m = v.shape
    j = [jnp.asarray(x) for x in (v, c, e, b)]
    want = np.asarray(jax_greedy(j[0], j[1], j[3], j[2], use_kernel=False))
    walk_assign, rem = _jax_walk_fn(n, m)(*j)
    assert np.array_equal(want, np.asarray(walk_assign))
    return want, np.asarray(rem)


@pytest.mark.parametrize("n,m,seed,kind", WALK_CASES)
def test_kernel_mirror_matches_reference(n, m, seed, kind):
    v, c, e, b = _inputs(n, m, seed, kind)
    want, want_rem = _reference(v, c, e, b)
    got, rem = _kernel_mirror(v, c, e, b)
    assert np.array_equal(want, got)
    assert bitwise(want_rem, rem)


@pytest.mark.parametrize("n,m,seed,kind", WALK_CASES)
def test_plain_walk_matches_reference(n, m, seed, kind):
    v, c, e, b = _inputs(n, m, seed, kind)
    want, want_rem = _reference(v, c, e, b)
    got, rem = budgeted_topk_walk(t_(v)[None], t_(c)[None], t_(b),
                                  t_(e)[None])
    assert got.dtype == torch.int32 and rem.dtype == torch.float32
    assert np.array_equal(want, np_(got)[0])
    assert bitwise(want_rem, rem[0])


def test_negative_cost_pick_needs_the_restart():
    """ES 0 starts below zero, so client 0 (free, the higher density) is
    passed; client 1's negative cost lifts the budget, and the reference
    then picks client 0. A pass without the restart misses it."""
    v = np.array([[0.9], [0.5]], np.float32)
    c = np.array([0.0, -2.0], np.float32)
    e = np.ones((2, 1), bool)
    b = np.array([-1.0], np.float32)
    want, want_rem = _reference(v, c, e, b)
    assert want.tolist() == [0, 0]
    got, rem = _kernel_mirror(v, c, e, b)
    assert np.array_equal(want, got) and bitwise(want_rem, rem)
    assert _kernel_mirror(v, c, e, b, restart=False)[0].tolist() == [-1, 0]


def _wrapper_args(s=2, n=5, m=3):
    rng = np.random.default_rng(0)
    return [torch.as_tensor(rng.random((s, n, m)).astype(np.float32)),
            torch.as_tensor(rng.uniform(0.3, 4.0, (s, n)).astype(
                np.float32)),
            torch.full((s, m), 3.5), torch.ones((s, n, m), dtype=torch.bool)]


@pytest.mark.parametrize("what,error,says", [
    ("values float64", TypeError, "values"),
    ("values 2-d", ValueError, "values"),
    ("costs shape", ValueError, "costs"),
    ("budgets shape", ValueError, "budgets"),
    ("eligible dtype", TypeError, "eligible"),
    ("on the cpu", ValueError, "expected CUDA"),
    ("over the limit", ValueError, str(MAX_PAIRS))])
def test_kernel_wrapper_checks_raise_before_building(monkeypatch, what,
                                                     error, says):
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", no_build)
    args = _wrapper_args()
    if what == "values float64":
        args[0] = args[0].double()
    elif what == "values 2-d":
        args[0] = args[0][0]
    elif what == "costs shape":
        args[1] = args[1][:, :4]
    elif what == "budgets shape":
        args[2] = args[2][0]
    elif what == "eligible dtype":
        args[3] = args[3].to(torch.uint8)
    elif what == "over the limit":
        args = _wrapper_args(1, MAX_PAIRS + 1, 1)
    with pytest.raises(error, match=says):
        budgeted_topk_kernel(*args)
