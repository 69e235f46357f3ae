"""The CUDA kernels against their plain PyTorch versions (the six that
replace TPU kernels with B2's tile grid, and Random's scan, P3's walk and
P2's segment walk). These
need an NVIDIA GPU (and nvcc to build the kernels at first use); on a
machine without one they skip. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import common

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


B1_KW = dict(tx_w=0.19952623149688797, noise_psd_w=3.981071705534969e-21,
             update_bits=0.18e6, workload=2.41e6)


def _context_inputs(dev, s, n, m, seed, dist=None):
    """pos, es, bandwidth, compute, fad_dt, fad_ut for B1; ``dist``
    (lo, hi) km puts each client at a log-uniform distance from ES 0."""
    from repro_torch.core.network import es_positions
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    es = es_positions(m)
    pos = rng.uniform(-3.5, 3.5, (s, n, 2))
    if dist is not None:
        r = np.exp(rng.uniform(np.log(dist[0]), np.log(dist[1]), (s, n)))
        a = rng.uniform(0, 2 * np.pi, (s, n))
        pos = es[0] + np.stack([r * np.cos(a), r * np.sin(a)], axis=-1)
    return [t(pos), t(es), t(rng.uniform(0.3e6, 1e6, (s, n))),
            t(rng.uniform(2e6, 4e6, (s, n))),
            t(rng.exponential(size=(s, n, m))),
            t(rng.exponential(size=(s, n, m)) * 1e-6)]


def _context_bitwise(k, r):
    for f in ("dist", "gain", "rate", "tau"):
        assert torch.equal(getattr(k, f), getattr(r, f)), f


@pytest.mark.parametrize("s,n,m", [(2, 1000, 12), (1, 37, 3), (3, 1, 1)])
def test_context_pairwise(dev, s, n, m):
    from repro_torch.kernels.context_pairwise.ops import pairwise_context
    from repro_torch.kernels.context_pairwise.ref import \
        pairwise_context_ref
    args = _context_inputs(dev, s, n, m, n)
    before = common.LAUNCHES["context_pairwise"]
    k = pairwise_context(*args, **B1_KW)
    assert common.LAUNCHES["context_pairwise"] == before + 1
    _context_bitwise(k, pairwise_context_ref(*args, **B1_KW))


def test_context_pairwise_over_the_path_loss_range(dev):
    """Four million pairs at distances from 1 m to 20 km, past both ends
    of what the path loss sees (its 0.01 km floor, the area's diagonal):
    the kernel's 10^x and everything after it bitwise."""
    from repro_torch.kernels.context_pairwise.ops import pairwise_context
    from repro_torch.kernels.context_pairwise.ref import \
        pairwise_context_ref
    args = _context_inputs(dev, 2, 250_000, 8, 7, dist=(0.001, 20.0))
    _context_bitwise(pairwise_context(*args, **B1_KW),
                     pairwise_context_ref(*args, **B1_KW))


def test_context_pairwise_wide_indices(dev):
    """The 64-bit instantiation, which the wrapper takes from 2^31 pairs
    on, launched through the C entry point at a small shape: the same
    bits as the 32-bit one."""
    from repro_torch.kernels.common import raise_on_error
    from repro_torch.kernels.context_pairwise.kernel import (
        _consts, _fn, context_pairwise_kernel)
    args = _context_inputs(dev, 2, 1000, 12, 3)
    narrow = context_pairwise_kernel(*args, **B1_KW)
    out = torch.empty((4, 2, 1000, 12), device=dev)
    raise_on_error(_fn()(*(a.data_ptr() for a in args), out.data_ptr(),
                         2, 1000, 12, _consts(*B1_KW.values())[1], 1,
                         torch.cuda.current_stream(dev).cuda_stream),
                   "context_pairwise")
    for i, f in enumerate(narrow):
        assert torch.equal(out[i], f)


def _topk_inputs(dev, s, n, m, kind, seed=0):
    """values, costs, budgets, eligible for the P2 kernel; ``kind`` as
    in ``tests/test_torch_budgeted_topk.py``."""
    rng = np.random.default_rng(seed)
    v = rng.random((s, n, m)).astype(np.float32)
    c = rng.uniform(0.3, 4.0, (s, n)).astype(np.float32)
    e = rng.random((s, n, m)) < 0.4
    b = np.full((s, m), 3.5, np.float32)
    if kind == "ties":
        v[:], c[:] = 0.5, 1.0
    elif kind == "ineligible":
        e[:] = False
    elif kind == "negative-cost":       # budgets that grow back
        c[:, ::5] = -rng.uniform(0.5, 2.0, c[:, ::5].shape)
        c[:, 1::7] = 0.0
        b[:, ::3] = -1.0
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(v), t(c), t(b), t(e)


def _topk_agrees(v, c, b, e):
    """One launch, no walk sync, assign and remaining bitwise those of
    the plain version on the same tensors."""
    from repro_torch.kernels.budgeted_topk.ops import (WALK_SYNCS,
                                                       budgeted_topk_walk)
    from repro_torch.kernels.budgeted_topk.ref import budgeted_topk_ref
    before = common.LAUNCHES["budgeted_topk"]
    syncs = WALK_SYNCS["greedy_walk"]
    ka, kr = budgeted_topk_walk(v, c, b, e)
    assert common.LAUNCHES["budgeted_topk"] == before + 1
    assert WALK_SYNCS["greedy_walk"] == syncs
    ra, rr = budgeted_topk_ref(v, c, b, e)
    assert torch.equal(ka, ra)
    assert torch.equal(kr.view(torch.int32), rr.view(torch.int32))
    return ka


@pytest.mark.parametrize("s,n,m,kind", [(2, 1000, 12, "random"),
                                        (1, 37, 3, "ties"),
                                        (2, 130, 3, "ties"),
                                        (2, 64, 12, "ineligible"),
                                        (2, 300, 12, "negative-cost"),
                                        (1, 1, 1, "random"),
                                        (2, 2048, 8, "random")])
def test_budgeted_topk(dev, s, n, m, kind):
    _topk_agrees(*_topk_inputs(dev, s, n, m, kind, seed=n))


def test_budgeted_topk_full_sort(dev):
    """Nearly every pair eligible at N * M = 16384: the 16-keys-a-thread
    sort of 16,384 keys."""
    v, c, b, e = _topk_inputs(dev, 2, 2048, 8, "random", seed=5)
    e = torch.rand(e.shape, generator=torch.Generator(device=dev)
                   .manual_seed(0), device=dev) < 0.95
    _topk_agrees(v, c, b, e)


def test_budgeted_topk_seeds_of_different_walk_lengths(dev):
    """A long walk, an empty one and a short one side by side give each
    seed's own walk."""
    parts = [_topk_inputs(dev, 1, 400, 6, kind, seed=i)
             for i, kind in enumerate(("random", "ineligible", "ties"))]
    parts[2][2].fill_(1.0)                  # one pick an ES
    stacked = [torch.cat(x) for x in zip(*parts)]
    got = _topk_agrees(*stacked)
    for i, one in enumerate(parts):
        assert torch.equal(got[i:i + 1], _topk_agrees(*one))
    picks = (got >= 0).sum(dim=1).tolist()
    assert picks[1] == 0 and picks[0] > picks[2] > 0


def test_budgeted_topk_refuses_over_the_limit(dev):
    """The one-pass kernel keeps its limit; past it ``budgeted_topk_walk``
    takes the tile grid and the segment walk instead (tested below)."""
    from repro_torch.kernels.budgeted_topk.kernel import (MAX_PAIRS,
                                                          budgeted_topk_kernel)
    before = common.LAUNCHES["budgeted_topk"]
    with pytest.raises(ValueError, match=str(MAX_PAIRS)):
        budgeted_topk_kernel(*_topk_inputs(dev, 1, MAX_PAIRS + 1, 1,
                                           "random"))
    assert common.LAUNCHES["budgeted_topk"] == before


def _tile_inputs(dev, s, n, m, kind, seed=0):
    """``_topk_inputs`` plus the cases of the tile grid: an ES no client
    can afford, all budgets zero."""
    v, c, b, e = _topk_inputs(dev, s, n, m,
                              kind if kind in ("ties", "ineligible",
                                               "negative-cost") else "random",
                              seed)
    if kind == "dead-es":
        b[:, 0] = 0.1                   # below every cost
    elif kind == "zero-budget":
        b.zero_()
    elif kind == "dense":               # nearly every pair eligible
        e = torch.rand(e.shape, generator=torch.Generator(device=dev)
                       .manual_seed(seed), device=dev) < 0.95
        b = b * 40.0
    return v, c, b, e


TILE_CASES = [(2, 3000, 12, 256, "random"), (1, 37, 3, 16, "random"),
              (2, 1000, 12, 128, "ties"), (2, 2000, 8, 512, "ineligible"),
              (2, 3000, 12, 1024, "dead-es"), (1, 5000, 4, 4096, "dense"),
              (2, 4100, 5, 2048, "negative-cost"),
              (1, 20000, 1, 16384, "zero-budget")]


@pytest.mark.parametrize("s,n,m,tile,kind", TILE_CASES)
def test_density_sort_tiles(dev, s, n, m, tile, kind):
    """B2's tile grid, the TPU kernel's own layout: one launch, each
    row's densities and flat indices bitwise ``density_sort_ref``."""
    from repro_torch.kernels.budgeted_topk.kernel import \
        density_sort_tiles_kernel
    from repro_torch.kernels.budgeted_topk.ref import density_sort_ref
    v, c, _, e = _tile_inputs(dev, s, n, m, kind, seed=n + m)
    before = common.LAUNCHES["density_sort_tiles"]
    kd, ki = density_sort_tiles_kernel(v, c, e, tile)
    assert common.LAUNCHES["density_sort_tiles"] == before + 1
    rd, ri = density_sort_ref(v, c, e, tile)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))
    assert torch.equal(ki, ri)


@pytest.mark.parametrize("s,n,m,tile,kind", TILE_CASES)
def test_segment_walk(dev, s, n, m, tile, kind):
    """P2's walk over the tile grid's segments: one launch, no host sync,
    assign and remaining bitwise ``ref.greedy_walk`` over the same
    segments."""
    from repro_torch.kernels.budgeted_topk.kernel import (
        density_sort_tiles_kernel, segment_walk_kernel)
    from repro_torch.kernels.budgeted_topk.ref import (WALK_SYNCS,
                                                       build_segments,
                                                       greedy_walk)
    v, c, b, e = _tile_inputs(dev, s, n, m, kind, seed=n + m)
    kd, ki = density_sort_tiles_kernel(v, c, e, tile)
    before, syncs = common.LAUNCHES["segment_walk"], WALK_SYNCS["greedy_walk"]
    ka, kr = segment_walk_kernel(kd, ki, c, b, m)
    assert common.LAUNCHES["segment_walk"] == before + 1
    assert WALK_SYNCS["greedy_walk"] == syncs
    ra, rr = greedy_walk(build_segments(v, c, e, tile), b, num_es=m,
                         num_clients=n)
    assert torch.equal(ka, ra)
    assert torch.equal(kr.view(torch.int32), rr.view(torch.int32))
    if kind == "zero-budget":
        assert (ka < 0).all()
    if kind == "dead-es":
        assert not (ka == 0).any() and (ka >= 0).any()


def test_budgeted_topk_past_the_limit_takes_the_tile_grid(dev):
    """Past ``MAX_PAIRS`` pairs a seed the P2 selection is the tile grid
    then the segment walk, one launch each and no host sync, bitwise the
    plain version."""
    from repro_torch.kernels.budgeted_topk.kernel import MAX_PAIRS
    from repro_torch.kernels.budgeted_topk.ops import (WALK_SYNCS,
                                                       budgeted_topk_walk)
    from repro_torch.kernels.budgeted_topk.ref import budgeted_topk_ref
    v, c, b, e = _topk_inputs(dev, 2, MAX_PAIRS // 12 + 1, 12, "random")
    before = dict(common.LAUNCHES)
    syncs = WALK_SYNCS["greedy_walk"]
    ka, kr = budgeted_topk_walk(v, c, b, e)
    assert common.LAUNCHES["budgeted_topk"] == before["budgeted_topk"]
    for k in ("density_sort_tiles", "segment_walk"):
        assert common.LAUNCHES[k] == before[k] + 1, k
    assert WALK_SYNCS["greedy_walk"] == syncs
    ra, rr = budgeted_topk_ref(v, c, b, e)
    assert torch.equal(ka, ra)
    assert torch.equal(kr.view(torch.int32), rr.view(torch.int32))


def _p3_inputs(dev, s, n, m, kind, seed=0):
    """values, costs, budgets, eligible for P3's and Random's kernels."""
    v, c, b, e = _topk_inputs(dev, s, n, m, kind, seed)
    if kind == "coarse":            # few distinct rates: ties to break
        v = torch.round(v * 3) / 3
        c = torch.round(c)
    b = b * (12.0 / 3.5) if n >= 500 else b
    return v, c, b, e


P3_CASES = [(2, 1000, 12, "random"), (2, 50, 3, "random"),
            (2, 50, 3, "ties"), (3, 130, 5, "coarse"),
            (2, 64, 12, "ineligible"), (1, 1, 1, "random"),
            (2, 1024, 16, "random"), (2, 2048, 8, "random")]


@pytest.mark.parametrize("s,n,m,kind", P3_CASES)
def test_flgreedy_walk(dev, s, n, m, kind):
    """B2's keys-only launch, then P3's walk: one launch each, no host
    sync, keys, assign and remaining bitwise the plain versions'."""
    from repro_torch.kernels.budgeted_topk.kernel import (
        budgeted_topk_keys_kernel, key_capacity)
    from repro_torch.kernels.budgeted_topk.ops import (WALK_SYNCS,
                                                       flgreedy_topk_walk)
    from repro_torch.kernels.budgeted_topk.ref import (candidate_keys_ref,
                                                       flgreedy_topk_ref)
    v, c, b, e = _p3_inputs(dev, s, n, m, kind, seed=n + m)
    keys, counts = budgeted_topk_keys_kernel(v, c, e)
    rk, rc = candidate_keys_ref(v, c, e, key_capacity(n, m))
    assert torch.equal(counts, rc) and torch.equal(keys, rk)
    before = dict(common.LAUNCHES)
    syncs = WALK_SYNCS["flgreedy_walk"]
    ka, kr = flgreedy_topk_walk(v, c, b, e)
    assert common.LAUNCHES["budgeted_topk"] == before["budgeted_topk"] + 1
    assert common.LAUNCHES["flgreedy_walk"] == before["flgreedy_walk"] + 1
    assert WALK_SYNCS["flgreedy_walk"] == syncs
    ra, rr = flgreedy_topk_ref(v, c, b, e)
    assert torch.equal(ka, ra)
    assert torch.equal(kr.view(torch.int32), rr.view(torch.int32))


@pytest.mark.parametrize("s,n,m,kind", P3_CASES + [(2, 300, 40, "random"),
                                                   (1, 200, 200, "random")])
def test_random_assign(dev, s, n, m, kind):
    """Random's scan on the same draws: one launch, bitwise the plain
    version's assign and remaining (M up to 200: several ESs a lane)."""
    from repro_torch import random as jr
    from repro_torch.kernels.random_assign.ops import (random_draws,
                                                       random_scan)
    from repro_torch.kernels.random_assign.ref import random_assign_ref
    v, c, b, e = _p3_inputs(dev, s, n, m, kind, seed=n)
    order, gum = random_draws(jr.PRNGKey(torch.arange(s, device=dev)), n,
                              m)
    if kind == "ties":
        gum = torch.round(gum)      # equal Gumbels: the lower ES wins
    before = common.LAUNCHES["random_assign"]
    ka, kr = random_scan(order, gum, c, b, e)
    assert common.LAUNCHES["random_assign"] == before + 1
    ra, rr = random_assign_ref(order, gum, c, b, e)
    assert torch.equal(ka, ra)
    assert torch.equal(kr.view(torch.int32), rr.view(torch.int32))


def test_new_kernels_refuse_over_their_limits(dev):
    from repro_torch.kernels.budgeted_topk.kernel import (
        MAX_PAIRS, budgeted_topk_keys_kernel)
    from repro_torch.kernels.random_assign.kernel import (
        MAX_ES, random_assign_kernel)
    v, c, b, e = _topk_inputs(dev, 1, MAX_PAIRS + 1, 1, "random")
    with pytest.raises(ValueError, match=str(MAX_PAIRS)):
        budgeted_topk_keys_kernel(v, c, e)
    m = MAX_ES + 1
    with pytest.raises(ValueError, match=str(MAX_ES)):
        random_assign_kernel(
            torch.zeros(1, 4, dtype=torch.int32, device=dev),
            torch.zeros(1, 4, m, device=dev), torch.zeros(1, 4, device=dev),
            torch.zeros(1, m, device=dev),
            torch.zeros(1, 4, m, dtype=torch.bool, device=dev))


@pytest.mark.parametrize("r,s,d,kind", [(24, 16, 7850, "random"),
                                        (24, 1, 7850, "random"),
                                        (5, 7, 100, "zero"),
                                        (24, 27, 7850, "random"),
                                        (3, 9, 257, "random"),
                                        (24, 27, 7850, "offset")])
def test_masked_aggregate(dev, r, s, d, kind):
    from repro_torch.kernels.masked_aggregate.ops import \
        masked_aggregate_flat
    from repro_torch.kernels.masked_aggregate.ref import \
        masked_aggregate_ref
    rng = np.random.default_rng(r * s)
    p = torch.as_tensor(rng.standard_normal((r, d)).astype(np.float32),
                        device=dev)
    dl = torch.as_tensor(rng.standard_normal((r, s, d)).astype(np.float32),
                         device=dev)
    w = torch.as_tensor((rng.random((r, s)) < 0.6).astype(np.float32),
                        device=dev)
    if kind == "zero":
        w.zero_()
    elif kind == "offset":      # 4 bytes past an 8-byte boundary: V = 1
        p, dl, w = (torch.cat([x.new_zeros(1), x.reshape(-1)])[1:]
                    .view(x.shape) for x in (p, dl, w))
    before = common.LAUNCHES["masked_aggregate"]
    k = masked_aggregate_flat(p, dl, w)
    assert common.LAUNCHES["masked_aggregate"] == before + 1
    assert torch.equal(k, masked_aggregate_ref(p, dl, w))


# B4 tolerance: float32 inputs, the kernel's fmaf chains and online
# softmax against float32 einsums, 1e-5; bfloat16 inputs, the kernel's
# output rounded once to bfloat16 against the float32 plain result: one
# bf16 ulp of values below 4, 2 ** -6. Every case passes the model's
# (B, S, H, D) tensors, which reach the kernel as transposed views.
FLASH_CASES = [
    (2, 100, 4, 2, 64, True, 0, torch.float32),
    (1, 512, 12, 2, 128, True, 0, torch.bfloat16),
    (1, 300, 4, 1, 128, True, 64, torch.float32),
    (1, 70, 4, 4, 64, False, 0, torch.float32),
    (2, 129, 8, 2, 128, True, 17, torch.bfloat16),
    (2, 100, 4, 2, 64, True, 0, torch.bfloat16),      # D = 64
    (2, 1, 12, 2, 128, True, 0, torch.bfloat16),      # S = 1
    (2, 1, 4, 2, 64, True, 0, torch.float32),
    (2, 1, 4, 1, 64, True, 0, torch.bfloat16),
    (1, 70, 4, 4, 64, False, 0, torch.bfloat16),      # ragged, non-causal
    (2, 200, 12, 2, 128, False, 0, torch.bfloat16),   # non-causal
    (1, 300, 4, 1, 128, True, 100, torch.bfloat16),   # window edge in a tile
    (1, 300, 4, 1, 64, True, 100, torch.bfloat16),
    (8, 512, 12, 2, 128, True, 0, torch.bfloat16),    # qwen2-1.5b's prompt
    (1, 512, 48, 8, 128, True, 4096, torch.bfloat16),  # mixtral-8x22b's
]


def _flash_inputs(dev, b, s, h, kv, d, dtype, fused=False):
    """Model layout. ``fused``: q, k, v are column slices of one (B, S,
    (H + 2 KV) D) projection, as a fused QKV matmul leaves them, so each
    is a non-contiguous view with a position stride of (H + 2 KV) D."""
    gen = torch.Generator(device=dev).manual_seed(s)
    if fused:
        qkv = torch.randn((b, s, (h + 2 * kv) * d), generator=gen,
                          device=dev).to(dtype)
        q, k, v = qkv.split([h * d, kv * d, kv * d], dim=-1)
        return (q.view(b, s, h, d), k.view(b, s, kv, d),
                v.view(b, s, kv, d))
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))


def _flash_check(q, k, v, causal, window):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    before = common.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert common.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert got.is_contiguous()          # written in the model's layout
    f32 = torch.float32
    want = attention_ref(*(a.transpose(1, 2).to(f32) for a in (q, k, v)),
                         causal=causal, window=window).transpose(1, 2)
    tol = 1e-5 if q.dtype == f32 else 2 ** -6
    torch.testing.assert_close(got.to(f32), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,dtype", FLASH_CASES)
def test_flash_attention(dev, b, s, h, kv, d, causal, window, dtype):
    q, k, v = _flash_inputs(dev, b, s, h, kv, d, dtype)
    _flash_check(q, k, v, causal, window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,kv,d,window", [(2, 129, 12, 2, 128, 0),
                                               (1, 300, 4, 1, 64, 100)])
def test_flash_attention_fused_views(dev, b, s, h, kv, d, window, dtype):
    q, k, v = _flash_inputs(dev, b, s, h, kv, d, dtype, fused=True)
    assert not q.is_contiguous()
    _flash_check(q, k, v, True, window)


# B5 tolerance: bf16 runs the chunked tensor-core kernel, which sums the
# state, inter-chunk and in-chunk parts of y in another order than the
# plain version's per-step einsums, over products of split operands (TF32
# hi/lo, 21-22 bits; bf16 in three pieces, 24 bits); a float64 emulation
# of that rounding (tools/rwkv6_split_emulation.py) erred by at most
# 4.8e-6 of max(1, |value|) for values up to ~120, and the tensor cores'
# own summation adds to it. float32 runs the sequential kernel: fused
# sums of 64 terms in another order. 1e-4 absolute and relative either
# way.
def _scan_inputs(dev, b, h, t, dtype, w0=-2.0, views=False, seed=0):
    """r, k, v (B, H, T, 64) in ``dtype``, log_w = -exp(0.5 N + w0) and u
    float32; with ``views`` the transposed views of (B, T, H, 64) tensors,
    as the model passes them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, t, h, 64) if views else (b, h, t, 64)
    r, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    lw = -torch.exp(torch.randn(shape, generator=gen, device=dev) * 0.5
                    + w0)
    u = torch.randn((h, 64), generator=gen, device=dev) * 0.2
    if views:
        r, k, v, lw = (a.transpose(1, 2) for a in (r, k, v, lw))
    return r, k, v, lw, u


def _scan_check(r, k, v, lw, u):
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    before = common.LAUNCHES["rwkv6_scan"]
    y, fin = rwkv6_scan(r, k, v, lw, u)
    assert common.LAUNCHES["rwkv6_scan"] == before + 1
    assert y.transpose(1, 2).is_contiguous()   # the model's layout
    wy, wf = rwkv6_scan_ref(r, k, v, lw, u)
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    torch.testing.assert_close(y, wy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fin, wf, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,h,t,dtype", [(2, 3, 100, torch.float32),
                                         (1, 4, 512, torch.bfloat16),
                                         (1, 1, 1, torch.float32)])
def test_rwkv6_scan(dev, b, h, t, dtype):
    _scan_check(*_scan_inputs(dev, b, h, t, dtype, seed=t))


# strong decays (w0 = 1, 3) make the reference's exp(-cumsum log_w) chunk
# factors overflow (R8); the model's strided views; ragged T
@pytest.mark.parametrize("b,h,t,dtype,w0,views", [
    (1, 4, 512, torch.bfloat16, 1.0, False),
    (1, 4, 512, torch.bfloat16, 3.0, False),
    (2, 3, 100, torch.bfloat16, 3.0, True),
    (2, 32, 512, torch.bfloat16, -2.0, True),
    (2, 32, 512, torch.float32, -2.0, True),
    (2, 3, 100, torch.bfloat16, -2.0, True),
    (2, 3, 100, torch.float32, 1.0, True),
    (1, 2, 1, torch.bfloat16, -2.0, True),
    (1, 2, 65, torch.bfloat16, 0.5, False),
])
def test_rwkv6_scan_decays_and_views(dev, b, h, t, dtype, w0, views):
    args = _scan_inputs(dev, b, h, t, dtype, w0, views, seed=t + h)
    assert views != args[0].is_contiguous() or t == 1
    _scan_check(*args)


# float32 reads its views element by element: any strides and offsets;
# bfloat16 reads them through TMA, which takes 16-byte strides and bases
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_view_alignment(dev, dtype):
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    b, h, t = 2, 3, 100
    gen = torch.Generator(device=dev).manual_seed(5)
    wide = (b, t, h, 65)        # 65-element rows, views from offset 1
    r, k, v = (torch.randn(wide, generator=gen, device=dev).to(dtype)
               [..., 1:].transpose(1, 2) for _ in range(3))
    lw = -torch.exp(torch.randn(wide, generator=gen, device=dev) * 0.5
                    - 2.0)[..., 1:].transpose(1, 2)
    u = torch.randn((h, 64), generator=gen, device=dev) * 0.2
    if dtype == torch.float32:
        _scan_check(r, k, v, lw, u)
    else:
        before = common.LAUNCHES["rwkv6_scan"]
        with pytest.raises(ValueError, match="16-byte aligned"):
            rwkv6_scan(r, k, v, lw, u)
        assert common.LAUNCHES["rwkv6_scan"] == before


# B6: indices equal to the plain version's on every row whose sorted
# probabilities, down to the (k+1)-th, are apart by more than 1e-6 or
# exactly equal (a tie, which both resolve to the lower index); gates
# within 1e-6 (float32 softmaxes summed in another order), each row's
# sum 1 within 1e-5. On a row with a non-finite logit (a NaN, a +inf,
# all -inf or all NaN: every probability NaN) the indices equal the
# plain version's, 0..k-1, and the gates are NaN.
@pytest.mark.parametrize("t,e,k,kind,dtype", [
    (4096, 8, 2, "normal", torch.float32),
    (8, 8, 2, "normal", torch.bfloat16),
    (1000, 8, 2, "normal", torch.float32),
    (4096, 384, 8, "normal", torch.float32),
    (512, 8, 2, "ties", torch.float32),
    (512, 64, 8, "ties", torch.bfloat16),
    (64, 8, 2, "underflow", torch.float32),
    (500, 8, 2, "nonfinite", torch.float32),
    (500, 8, 2, "nonfinite", torch.bfloat16),
    (500, 32, 8, "nonfinite", torch.float32),
    (500, 384, 8, "nonfinite", torch.float32),
    (1000, 32, 8, "normal", torch.float32),     # widest thread-a-row
    (1000, 33, 8, "normal", torch.float32),     # narrowest warp-a-row
    (1000, 5, 2, "normal", torch.float32),      # rows not 16-byte aligned
    (1000, 6, 2, "normal", torch.bfloat16),
    (1, 8, 2, "normal", torch.float32),
    (1000, 8, 2, "row_offset", torch.float32),  # a view one row in
    (1000, 8, 2, "elem_offset", torch.float32),  # base not 16-byte aligned
    (1000, 8, 2, "tiny", torch.float32),        # p below 2^-117
    (1000, 32, 8, "tiny", torch.float32),
])
def test_moe_router(dev, t, e, k, kind, dtype):
    from repro_torch.kernels.moe_router.ops import moe_router
    from repro_torch.kernels.moe_router.ref import moe_router_ref
    gen = torch.Generator(device=dev).manual_seed(t + e)
    if kind == "ties":
        x = torch.randint(0, 3, (t, e), generator=gen, device=dev).float()
    elif kind == "row_offset":
        x = torch.randn((t + 1, e), generator=gen, device=dev)[1:]
    elif kind == "elem_offset":
        x = torch.randn((t * e + 1,), generator=gen, device=dev)[1:]
        x = x.view(t, e)
    else:
        x = torch.randn((t, e), generator=gen, device=dev)
    if kind == "underflow":
        x[:, 1:] -= 200.0
    if kind == "tiny":      # half the row 85-105 below the rest
        x[:, e // 2:] = -85.0 - 20.0 * torch.rand(
            (t, e - e // 2), generator=gen, device=dev)
    if kind == "nonfinite":
        rows = torch.arange(t, device=dev)
        x[rows[0::5], rows[0::5] % e] = float("nan")
        x[rows[1::5], rows[1::5] % e] = float("inf")
        x[2::5] = float("-inf")
        x[3::5] = float("nan")
    x = x.to(dtype)
    assert x.is_contiguous()
    before = common.LAUNCHES["moe_router"]
    g, i = moe_router(x, k)
    assert common.LAUNCHES["moe_router"] == before + 1
    wg, wi = moe_router_ref(x, k)
    bad = ~torch.isfinite(x.float()).all(-1)
    assert int(bad.sum()) == (4 * t // 5 if kind == "nonfinite" else 0)
    assert torch.equal(i[bad], wi[bad])
    assert (i[bad] == torch.arange(k, device=dev)).all()
    assert g[bad].isnan().all() and wg[bad].isnan().all()
    x, g, i, wg, wi = x[~bad], g[~bad], i[~bad], wg[~bad], wi[~bad]
    p = torch.sort(torch.softmax(x.float(), -1), -1, descending=True)[0]
    gaps = (p[:, :k] - p[:, 1:k + 1]).abs()
    decided = ((gaps > 1e-6) | (gaps == 0)).all(-1)
    assert torch.equal(i[decided], wi[decided])
    assert decided.float().mean().item() > 0.99
    torch.testing.assert_close(g, wg, rtol=0, atol=1e-6)
    torch.testing.assert_close(g.sum(-1), torch.ones_like(g[:, 0]), rtol=0,
                               atol=1e-5)
    if kind == "underflow":
        assert (i[:, 0] == 0).all() and (i[:, 1] == 1).all()
