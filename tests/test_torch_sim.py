"""The port's round generator (``sim_round``) fed the reference's own
``round_draws`` (the ``dr`` override), against the reference's
``sim_round``: 3 rounds x 2 seeds on ``paper`` and ``metropolis-1k``."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import ENV_RTOL, bitwise, max_rel, np_, t_  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.sim import core as jcore  # noqa: E402
from repro.sim import draws as jdraws  # noqa: E402
from repro_torch.kernels.context_pairwise.ref import (  # noqa: E402
    latency, pairwise_context_ref)
from repro_torch.sim import core as tcore  # noqa: E402
from repro_torch.sim import draws as tdraws  # noqa: E402
from repro_torch.sim import spec as tspec  # noqa: E402


def _stack_draws(per_seed):
    return tdraws.RoundDraws(*(torch.stack([t_(getattr(d, f))
                                            for d in per_seed])
                               for f in tdraws.RoundDraws._fields))


@pytest.mark.parametrize("preset", ["paper", "metropolis-1k",
                                    "tiered-pricing", "bursty-arrival"])
def test_sim_round_matches_reference(preset):
    env = jsim.make(preset)
    js = env.spec
    ts = tspec.make(preset).spec
    seeds = (0, 1)
    n, m = js.num_clients, js.num_edge_servers
    init = jax.jit(jcore.init_statics, static_argnums=0)
    jst = [init(js, jnp.uint32(s)) for s in seeds]
    tst = tcore.init_statics(ts, torch.tensor(seeds))
    for f in ("pos0", "price", "base_bw", "base_comp", "arrival_phase"):
        assert bitwise(np.stack([np.asarray(getattr(x, f)) for x in jst]),
                       getattr(tst, f)), f
    jpos = [x.pos0 for x in jst]
    tpos = tst.pos0
    step = jax.jit(jcore.sim_round, static_argnums=0)
    n_flips = [0]
    for t in range(3):
        dr = [jdraws.round_draws(s, t, n, m, js.mc_true_p) for s in seeds]
        outs = [step(js, jnp.uint32(s), st, p, jnp.int32(t), d)
                for s, st, p, d in zip(seeds, jst, jpos, dr)]
        jpos = [o[0] for o in outs]
        want = [o[1] for o in outs]
        tdr = _stack_draws(dr)
        tpos, got = tcore.sim_round(ts, torch.tensor(seeds), tst, tpos, t,
                                    dr=tdr)
        w = lambda g: np.stack([np.asarray(g(x)) for x in want])
        assert bitwise(w(lambda x: x.round.costs), got.round.costs)
        assert bitwise(w(lambda x: x.bandwidth), got.bandwidth)
        assert bitwise(np.stack([np.asarray(p) for p in jpos]), tpos)
        for f in ("contexts", "latency"):
            assert max_rel(w(lambda x: getattr(x.round, f)),
                           getattr(got.round, f)) <= ENV_RTOL, f
        # eligibility: distances are bitwise, so no radius flip at all
        assert bitwise(w(lambda x: x.round.eligible), got.round.eligible)
        # outcomes: a flip may only sit at the deadline
        tau = np_(got.round.latency)
        flip = w(lambda x: x.round.outcomes) != np_(got.round.outcomes)
        assert np.all(np.abs(tau[flip] - js.deadline_s)
                      <= ENV_RTOL * js.deadline_s)
        # true_p: a Monte-Carlo sample may only flip at the deadline
        tp_w, tp_g = w(lambda x: x.round.true_p), np_(got.round.true_p)
        bad = tp_w != tp_g
        if bad.any():
            gain = pairwise_context_ref(
                tpos, tcore.es_table(ts, "cpu"), got.bandwidth,
                got.compute, tdr.fad_dt, tdr.fad_ut, tx_w=ts.tx_w,
                noise_psd_w=ts.noise_psd_w, update_bits=ts.update_bits,
                workload=ts.workload).gain
            tau_mc = np_(latency(
                got.bandwidth[:, None, :, None],
                got.compute[:, None, :, None], tdr.mc_dt, tdr.mc_ut,
                gain[:, None], tx_w=ts.tx_w, noise_psd_w=ts.noise_psd_w,
                update_bits=ts.update_bits, workload=ts.workload))
            near = (np.abs(tau_mc - js.deadline_s)
                    <= ENV_RTOL * js.deadline_s).any(axis=1)
            assert near[bad].all()
        n_flips[0] += int(bad.sum())
        assert np.abs(tp_w - tp_g).max() <= 2.0 / js.mc_true_p
    print(f"{preset}: {n_flips[0]} true_p entries moved by a Monte-Carlo "
          "sample at the deadline")


def test_flash_crowd_waits_for_the_permutation():
    """``flash-crowd`` waited on the ``permutation`` draw, which picks its
    surge cohort. Now: the cohort (``surge_mask``) equals the reference's
    bitwise, and so do the costs, in and out of a surge (rounds 0-11 of a
    50-round period whose first 10 discount the cohort), with the
    reference's own round draws fed to the port."""
    env = jsim.make("flash-crowd")
    js = env.spec
    ts = tspec.make("flash-crowd").spec
    assert ts.surge_count == js.surge_count > 0
    assert ts.min_cost() == js.min_cost()
    seeds = (0, 1, 2)
    n, m = js.num_clients, js.num_edge_servers
    init = jax.jit(jcore.init_statics, static_argnums=0)
    jst = [init(js, jnp.uint32(s)) for s in seeds]
    tst = tcore.init_statics(ts, torch.tensor(seeds))
    want_mask = np.stack([np.asarray(x.surge_mask) for x in jst])
    assert bitwise(want_mask, tst.surge_mask)
    assert (want_mask.sum(axis=1) == js.surge_count).all()
    step = jax.jit(jcore.sim_round, static_argnums=0)
    jpos, tpos = [x.pos0 for x in jst], tst.pos0
    discounted = 0
    for t in range(12):
        dr = [jdraws.round_draws(s, t, n, m, js.mc_true_p) for s in seeds]
        outs = [step(js, jnp.uint32(s), st, p, jnp.int32(t), d)
                for s, st, p, d in zip(seeds, jst, jpos, dr)]
        jpos = [o[0] for o in outs]
        tpos, got = tcore.sim_round(ts, torch.tensor(seeds), tst, tpos, t,
                                    dr=_stack_draws(dr))
        want = np.stack([np.asarray(o[1].round.costs) for o in outs])
        assert bitwise(want, got.round.costs), f"round {t}"
        discounted += int(t < js.surge_len) * int(want_mask.sum())
    assert discounted > 0
