"""The three CUDA kernels against their plain PyTorch versions. These
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


@pytest.mark.parametrize("s,n,m", [(2, 1000, 12), (1, 37, 3), (3, 1, 1)])
def test_context_pairwise(dev, s, n, m):
    from repro_torch.core.network import es_positions
    from repro_torch.kernels.context_pairwise.ops import pairwise_context
    from repro_torch.kernels.context_pairwise.ref import \
        pairwise_context_ref
    rng = np.random.default_rng(n)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    args = [t(rng.uniform(-3.5, 3.5, (s, n, 2))), t(es_positions(m)),
            t(rng.uniform(0.3e6, 1e6, (s, n))),
            t(rng.uniform(2e6, 4e6, (s, n))),
            t(rng.exponential(size=(s, n, m))),
            t(rng.exponential(size=(s, n, m)) * 1e-6)]
    kw = dict(tx_w=0.19952623149688797, noise_psd_w=3.981071705534969e-21,
              update_bits=0.18e6, workload=2.41e6)
    before = common.LAUNCHES["context_pairwise"]
    k = pairwise_context(*args, **kw)
    assert common.LAUNCHES["context_pairwise"] == before + 1
    r = pairwise_context_ref(*args, **kw)
    assert torch.equal(k.dist, r.dist)
    for f in ("gain", "rate", "tau"):
        a, b = getattr(k, f), getattr(r, f)
        assert ((a - b).abs() / b.abs()).max().item() <= 5e-6


@pytest.mark.parametrize("s,n,m,kind", [(2, 1000, 12, "random"),
                                        (1, 37, 3, "ties"),
                                        (2, 64, 12, "ineligible")])
def test_density_sort(dev, s, n, m, kind):
    from repro_torch.kernels.budgeted_topk.ops import sorted_candidates
    from repro_torch.kernels.budgeted_topk.ref import density_sort_ref
    rng = np.random.default_rng(n)
    v = rng.random((s, n, m)).astype(np.float32)
    c = rng.uniform(0.3, 4.0, (s, n)).astype(np.float32)
    e = rng.random((s, n, m)) < 0.4
    if kind == "ties":
        v[:], c[:] = 0.5, 1.0
    elif kind == "ineligible":
        e[:] = False
    v, c, e = (torch.as_tensor(a, device=dev) for a in (v, c, e))
    before = common.LAUNCHES["budgeted_topk"]
    kd, ki = sorted_candidates(v, c, e)
    assert common.LAUNCHES["budgeted_topk"] == before + 1
    rd, ri = density_sort_ref(v, c, e)
    assert torch.equal(kd, rd) and torch.equal(ki, ri)


@pytest.mark.parametrize("r,s,d,kind", [(24, 16, 7850, "random"),
                                        (24, 1, 7850, "random"),
                                        (5, 7, 100, "zero")])
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
    before = common.LAUNCHES["masked_aggregate"]
    k = masked_aggregate_flat(p, dl, w)
    assert common.LAUNCHES["masked_aggregate"] == before + 1
    torch.testing.assert_close(k, masked_aggregate_ref(p, dl, w),
                               rtol=1e-6, atol=1e-6)
