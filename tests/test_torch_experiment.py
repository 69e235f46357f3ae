"""The paper's experiment end to end, the port's ``sweep_experiments``
against the reference's on the CPU: COCS, Oracle and Random on
``paper``, ``flash-crowd`` and ``metropolis-1k`` with logistic
regression (the CNN: ``test_torch_experiment_cnn.py``). Selections,
utilities, participants and the explored flags are bitwise; accuracy
and loss agree to ``SWEEP_ACC_TOL``, the reference's own fused-vs-host
tolerance."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.data.federated import FederatedDataset as JData  # noqa: E402
from repro.experiment.sweep import sweep_experiments as jax_sweep  # noqa
from repro_torch.data.federated import FederatedDataset  # noqa: E402
from _torch_parity import SWEEP_POLICIES as POLICIES  # noqa: E402
from _torch_parity import sweeps_agree as _agree  # noqa: E402
from repro_torch.experiment import sweep as tsweep  # noqa: E402

CASES = {
    # preset, seeds, horizon, eval_every, slots, samples per client
    "paper": ("paper", (0, 1), 6, 3, 11, None),
    "flash-crowd": ("flash-crowd", (0, 1), 6, 3, 11, None),
    "metropolis-1k": ("metropolis-1k", (0,), 2, 5, 40, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_policies_logreg(case):
    preset, seeds, horizon, every, slots, samples = CASES[case]
    jdata = tdata = None
    if samples is not None:
        kw = dict(samples_per_client=samples, test_samples=200, seed=0)
        jdata = JData.synthetic(1000, **kw)
        tdata = FederatedDataset.synthetic(1000, **kw)
    args = dict(seeds=seeds, horizon=horizon, eval_every=every,
                slots_per_es=slots)
    want = jax_sweep(POLICIES, f"device:{preset}", data=jdata, **args)
    got = tsweep.sweep_experiments(POLICIES, f"device:{preset}",
                                   data=tdata, device="cpu", **args)
    _agree(want, got)
    # Oracle knows the outcomes: it never gets fewer participants
    assert (got.participants["oracle"].sum(axis=1)
            >= got.participants["random"].sum(axis=1)).all()


def test_entry_point_asks_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsweep.sweep_experiments(("random",), "device:flash-crowd",
                                 seeds=(0,), horizon=1)


def test_unknown_policy_and_model_are_refused():
    with pytest.raises(KeyError, match="oracle"):
        tsweep.sweep_experiments(("ucb",), "device:paper", seeds=(0,),
                                 horizon=1, device="cpu")
    with pytest.raises(ValueError, match="cnn"):
        tsweep.sweep_experiments(("cocs",), "device:paper", seeds=(0,),
                                 horizon=1, device="cpu", model_kind="mlp")
