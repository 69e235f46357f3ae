"""COCS select/update of the port against the reference's, fed the
reference's realized rounds, with the reference's state carried into the
port every round (``cocs_state_from_numpy``): assignments and state are
bitwise."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_parity import bitwise, np_, t_  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.policies.base import PolicySpec as JSpec  # noqa: E402
from repro.policies.base import Round as JRound  # noqa: E402
from repro.policies.cocs import COCS as JCOCS  # noqa: E402
from repro.policies.engine import stack_states  # noqa: E402
from repro_torch.models.convert import cocs_state_from_numpy  # noqa: E402
from repro_torch.policies.base import PolicySpec, Round  # noqa: E402
from repro_torch.policies.cocs import COCS  # noqa: E402


@pytest.mark.parametrize("preset,horizon", [("paper", 10),
                                            ("metropolis-1k", 4)])
def test_select_update_bitwise_over_rounds(preset, horizon):
    env = jsim.make(preset)
    cfg, seeds = env.cfg, (0, 1)
    rounds = env.rollout_device(seeds, horizon).round     # (S, T, ...)
    jpol = JCOCS(spec=JSpec.from_experiment(cfg, horizon), alpha=1.0,
                 h_t=cfg.h_t)
    tpol = COCS(spec=PolicySpec.from_experiment(cfg, horizon), alpha=1.0,
                h_t=cfg.h_t)
    select = jax.jit(jax.vmap(jpol.select))
    update = jax.jit(jax.vmap(jpol.update))
    state = stack_states(jpol, seeds)
    init = tpol.init(len(seeds))
    assert bitwise(state.counters, init.counters)
    assert bitwise(state.p_hat, init.p_hat)
    explored_any = False
    for t in range(horizon):
        rd = JRound(*(getattr(rounds, f)[:, t] for f in JRound._fields))
        assign, aux = select(state, rd)
        new = update(state, rd, assign, aux)
        trd = Round(*(t_(np.asarray(getattr(rd, f)))
                      for f in Round._fields))
        tstate = cocs_state_from_numpy(np.asarray(state.counters),
                                       np.asarray(state.p_hat))
        tassign, taux = tpol.select(tstate, trd)
        tnew = tpol.update(tstate, trd, tassign, taux)
        assert bitwise(assign, tassign), f"round {t}"
        assert bitwise(aux["explored"], taux["explored"])
        assert bitwise(new.counters, tnew.counters), f"round {t}"
        assert bitwise(new.p_hat, tnew.p_hat), f"round {t}"
        explored_any |= bool(np.asarray(aux["explored"]).any())
        state = new
    assert explored_any
    assert int(np_(tnew.counters).sum()) > 0


def test_cocs_values_and_threshold():
    """The optimistic value table on a hand-made state: an unvisited
    cube scores 1.0, a visited one est + bonus, capped at 1."""
    spec = PolicySpec(num_clients=2, num_edge_servers=1, budget=1.0,
                      horizon=10)
    pol = COCS(spec=spec, h_t=2)
    st = pol.init(1)
    st.counters[0, 1, 0, 1, 1] = 3
    st.p_hat[0, 1, 0, 1, 1] = 0.25
    rd = Round(t=torch.tensor([4], dtype=torch.int32),
               contexts=torch.tensor([[[[0.1, 0.1]], [[0.9, 0.9]]]]),
               eligible=torch.ones(1, 2, 1, dtype=torch.bool),
               costs=torch.ones(1, 2), outcomes=torch.ones(1, 2, 1),
               true_p=torch.ones(1, 2, 1), latency=torch.ones(1, 2, 1))
    values, under = pol.pair_values(st, rd)
    assert values[0, 0, 0] == 1.0 and bool(under.all())
    bonus = 0.35 * np.sqrt(2 * np.log(5.0) / 3)
    assert abs(float(values[0, 1, 0]) - min(0.25 + bonus, 1.0)) < 1e-6
