"""The non-convex setting end to end: the port's ``sweep_experiments``
against the reference's on the CPU, COCS, Oracle and Random on ``paper``
under ``CIFAR10_NONCONVEX`` with the CNN (P3's FLGreedy, the sqrt
utility). Selections, utilities, participants and the explored flags
are bitwise; accuracy and loss agree to ``SWEEP_ACC_TOL``. Cut to 10
clients, 1 local epoch, 2 rounds and the (16, 16, 3) ``cifar_small``
shape, at lr = 0.005 (at the configuration's lr = 0.1 the CNN's SGD
diverges, R11), from the reference's params carried across (the port's
init draws normals within a few ulp, not bitwise)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from _torch_parity import SWEEP_POLICIES as POLICIES  # noqa: E402
from _torch_parity import sweeps_agree as _agree  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.configs.paper_hfl import CIFAR10_NONCONVEX as JNC  # noqa: E402
from repro.data.federated import FederatedDataset as JData  # noqa: E402
from repro.experiment.sweep import sweep_experiments as jax_sweep  # noqa
from repro.models.logistic import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.configs.paper_hfl import CIFAR10_NONCONVEX  # noqa: E402
from repro_torch.data.federated import FederatedDataset  # noqa: E402
from repro_torch.experiment import sweep as tsweep  # noqa: E402
from repro_torch.models.convert import cnn_params_from_jax  # noqa: E402
from repro_torch.sim import spec as tspec  # noqa: E402


def test_three_policies_cnn(monkeypatch):
    shape, n, seeds = (16, 16, 3), 10, (0,)
    jcfg = dataclasses.replace(JNC, num_clients=n, local_epochs=1,
                               lr=0.005)
    tcfg = dataclasses.replace(CIFAR10_NONCONVEX, num_clients=n,
                               local_epochs=1, lr=0.005)
    kw = dict(samples_per_client=40, test_samples=200, seed=0)
    jdata = JData.synthetic(n, kind="cifar_small", **kw)
    tdata = FederatedDataset.synthetic(n, kind="cifar_small", **kw)
    args = dict(seeds=seeds, horizon=2, eval_every=1, model_kind="cnn")
    want = jax_sweep(POLICIES, jsim.make("paper", jcfg), data=jdata, **args)

    def carried(key, h, w, c):
        seed = int(key[1])
        tree = {k: np.asarray(v) for k, v in jax_init_cnn(
            jax.random.PRNGKey(seed), h, w, c).items()}
        return cnn_params_from_jax(tree, h, w, key.device)

    monkeypatch.setattr(tsweep, "init_cnn", carried)
    got = tsweep.sweep_experiments(POLICIES, tspec.make("paper", tcfg),
                                   data=tdata, device="cpu", **args)
    assert tdata.test_x.shape[1:] == shape
    _agree(want, got)
    for p in POLICIES:      # sqrt(participants / M): Eq. 19's utility
        assert np.allclose(got.utilities[p],
                           np.sqrt(got.participants[p] / 3.0))
