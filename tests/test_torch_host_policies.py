"""The host-state policies (CUCB, LinUCB, phased COCS and the numpy COCS)
against the reference on the CPU.

Both packages are fed the reference's realized ``RoundData`` (``paper``,
``mnist-convex``), so every difference would be the policies' own. Over
60 rounds and 2 seeds, ``run_rounds_host`` gives the reference's
selections, utilities, participants and explored flags bit for bit, for
the registry's host policies and for ``HostCOCS`` in both modes, under
the linear and the sqrt utility."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: E402,F401
from repro import envs as JE  # noqa: E402
from repro import policies as JP  # noqa: E402
from repro.configs.paper_hfl import (CIFAR10_NONCONVEX,  # noqa: E402
                                     MNIST_CONVEX)
from repro_torch import policies as TP  # noqa: E402
from repro_torch.core.network import RoundData  # noqa: E402
from repro_torch.core.utility import (POLICY_TABLE,  # noqa: E402
                                      _policy_kwargs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("selections", "utilities", "participants", "explored")
SEEDS = (0, 1)
HORIZON = 60


@pytest.fixture(scope="module")
def rounds():
    """The reference's rollouts, and the same rounds as the port's
    ``RoundData`` (field for field, the same arrays)."""
    out = {}
    for key, cfg in (("linear", MNIST_CONVEX), ("sqrt", CIFAR10_NONCONVEX)):
        env = JE.make("paper", cfg)
        want = {s: env.rollout(s, HORIZON) for s in SEEDS}
        got = {s: [RoundData(**{f.name: getattr(rd, f.name)
                                for f in dataclasses.fields(rd)})
                   for rd in want[s]] for s in SEEDS}
        out[key] = (cfg, want, got)
    return out


def _pair(name, cfg):
    from repro_torch.configs.paper_hfl import get_config
    tcfg = get_config(cfg.name)
    kw = _policy_kwargs(tcfg, name)
    jpol = JP.make(name, JP.PolicySpec.from_experiment(cfg, HORIZON), **kw)
    tpol = TP.make(name, TP.PolicySpec.from_experiment(tcfg, HORIZON), **kw)
    return jpol, tpol


CASES = [("cucb", "linear"), ("linucb", "linear"), ("cocs-phased", "linear"),
         ("cucb", "sqrt"), ("cocs-phased", "sqrt")]


@pytest.mark.parametrize("name,utility", CASES)
def test_run_rounds_host_bitwise(rounds, name, utility):
    cfg, want_rounds, got_rounds = rounds[utility]
    jpol, tpol = _pair(name, cfg)
    assert not tpol.tensor_capable
    offset = dict(POLICY_TABLE.values()).get(name, 0)
    for s in SEEDS:
        want = JP.run_rounds_host(jpol, want_rounds[s], seed=s + offset)
        got = TP.run_rounds_host(tpol, got_rounds[s], seed=s + offset)
        for f in FIELDS:
            w, g = np.asarray(want[f]), got[f]
            assert g.dtype == w.dtype and np.array_equal(w, g), (f, s)
        assert (got["selections"] >= 0).any()


def test_host_cocs_index_mode(rounds):
    """The numpy COCS in index mode (``HostCOCS``, phased off) against
    the reference's; ``run_rounds_host`` and ``PolicyAdapter`` refuse a
    tensor policy and name ``run_rounds``, which drives it."""
    from repro.policies.baselines import HostCOCS as JHost
    cfg, want_rounds, got_rounds = rounds["linear"]
    kw = {"alpha": cfg.holder_alpha, "h_t": cfg.h_t}
    jpol = JHost(spec=JP.PolicySpec.from_experiment(cfg, HORIZON), **kw)
    tspec = TP.PolicySpec.from_experiment(cfg, HORIZON)
    tpol = TP.HostCOCS(spec=tspec, **kw)
    for s in SEEDS:
        want = JP.run_rounds_host(jpol, want_rounds[s], seed=s)
        got = TP.run_rounds_host(tpol, got_rounds[s], seed=s)
        for f in FIELDS:
            assert np.array_equal(np.asarray(want[f]), got[f]), (f, s)
        assert got["explored"].any()
    for name in ("cocs", "oracle", "random"):
        tensor_pol = TP.make(name, tspec)
        with pytest.raises(ValueError, match="run_rounds drives"):
            TP.run_rounds_host(tensor_pol, got_rounds[0], seed=0)
        with pytest.raises(ValueError, match="run_rounds drives"):
            TP.PolicyAdapter(tensor_pol, seed=0)


def test_adapter_and_registry(rounds):
    _, _, got_rounds = rounds["linear"]
    assert set(TP.names()) == {"cocs", "cocs-phased", "cucb", "linucb",
                               "oracle", "random"}
    spec = TP.PolicySpec.from_experiment(MNIST_CONVEX, HORIZON)
    pol = TP.make("cocs-phased", spec, h_t=5)
    assert isinstance(pol, TP.HostCOCS) and pol.phased
    a, b = TP.PolicyAdapter(pol, seed=0), TP.PolicyAdapter(pol, seed=0)
    for rd in got_rounds[0][:10]:
        x = a.step(rd)
        y = b.select(rd)
        b.update(rd, y)
        assert np.array_equal(x, y) and a.last_explored == b.last_explored
    with pytest.raises(TypeError, match="RoundData"):
        pol.select(pol.init(0), TP.round_from_arrays(
            TP.stack_rounds(got_rounds[0][:1])))
    assert torch.equal(torch.as_tensor(a.state.counters),
                       torch.as_tensor(b.state.counters))
