"""The facade on the card: ``repro_torch.run`` tier 1 on CUDA launches
the path's kernels (no plain route), matches the CPU run of the same
spec, and refuses ``use_kernel=False``. These need an NVIDIA GPU; on a
machine without one they skip. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_api_cuda.py
"""
import dataclasses

import pytest
import torch

import repro_torch
from repro_torch import api
from repro_torch.kernels import common
from repro_torch.kernels.budgeted_topk import ops as topk_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _spec(**kw):
    base = api.ExperimentSpec(env=api.EnvSpec("paper", backend="device"),
                              horizon=8, seeds=(0, 1))
    return dataclasses.replace(base, **kw)


@pytest.mark.parametrize("reg,kernel", [("cocs", "budgeted_topk"),
                                        ("oracle", "budgeted_topk"),
                                        ("random", "random_assign")])
def test_tier1_launches_and_matches_cpu(dev, reg, kernel):
    spec = _spec(policy=api.PolicySpec(reg))
    common.reset_launches()
    for k in topk_ops.WALK_SYNCS:
        topk_ops.WALK_SYNCS[k] = 0
    got = repro_torch.run(spec, device=dev)
    assert common.LAUNCHES["context_pairwise"] == spec.horizon
    assert common.LAUNCHES[kernel] == spec.horizon
    assert not any(topk_ops.WALK_SYNCS.values())
    want = repro_torch.run(spec, device="cpu")
    rows = int((want.selections != got.selections).any(axis=-1).sum())
    # phase 5's rule: at most 1% of (seed, round) rows differ
    assert rows <= 0.01 * got.selections.shape[0] * got.selections.shape[1]


def test_plain_route_refused_on_cuda(dev):
    for spec in (_spec(env=api.EnvSpec("paper", backend="device",
                                       use_kernel=False)),
                 _spec(train=api.TrainSpec(use_kernel=False))):
        common.reset_launches()
        with pytest.raises(ValueError, match="use_kernel"):
            repro_torch.run(spec, device=dev)
        assert not any(common.LAUNCHES.values())
