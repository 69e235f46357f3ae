"""The slice end to end: the port's ``sweep_experiments`` against the
reference's, same arguments, ``slots_per_es`` pinned on both sides, on
the CPU. Selections, utilities and participants are bitwise; accuracy
and loss agree to 1e-4, the reference's own fused-vs-host tolerance."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.data.federated import FederatedDataset as JData  # noqa: E402
from repro.experiment.sweep import sweep_experiments as jax_sweep  # noqa
from repro_torch.data.federated import FederatedDataset  # noqa: E402
from repro_torch.experiment.sweep import sweep_experiments  # noqa: E402

ACC_TOL = 1e-4
CASES = {
    # preset, seeds, horizon, eval_every, slots, samples per client
    "paper": ("paper", (0, 1), 10, 5, 11, None),
    "metropolis-1k": ("metropolis-1k", (0, 1), 3, 5, 40, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_matches_reference(case):
    preset, seeds, horizon, every, slots, samples = CASES[case]
    jdata = tdata = None
    if samples is not None:
        kw = dict(samples_per_client=samples, test_samples=200, seed=0)
        jdata = JData.synthetic(1000, **kw)
        tdata = FederatedDataset.synthetic(1000, **kw)
    args = dict(seeds=seeds, horizon=horizon, eval_every=every,
                slots_per_es=slots)
    want = jax_sweep(("cocs",), f"device:{preset}", data=jdata, **args)
    got = sweep_experiments(("cocs",), f"device:{preset}", data=tdata,
                            device="cpu", **args)
    assert list(got.eval_rounds) == list(want.eval_rounds)
    for f in ("selections", "utilities", "participants", "explored"):
        w, g = np.asarray(getattr(want, f)["cocs"]), getattr(got, f)["cocs"]
        assert g.shape == w.shape, f
        assert np.array_equal(w, g), f
    for f in ("accuracy", "loss"):
        w, g = np.asarray(getattr(want, f)["cocs"]), getattr(got, f)["cocs"]
        assert np.all(np.isfinite(g))
        assert np.abs(w - g).max() <= ACC_TOL, f
    assert (got.selections["cocs"] >= 0).any()


def test_entry_point_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_experiments(("cocs",), "device:paper", seeds=(0,), horizon=1)


def test_pinned_capacity_overflow_raises():
    with pytest.raises(ValueError, match="slots_per_es"):
        sweep_experiments(("cocs",), "device:paper", seeds=(0,), horizon=2,
                          slots_per_es=1, device="cpu")
