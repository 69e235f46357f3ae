"""Slot packing and the slot-capacity bound against the reference."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import bitwise, t_  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.experiment.packing import pack_assignment as jax_pack  # noqa
from repro.experiment.packing import slot_capacity as jax_capacity  # noqa
from repro_torch.experiment.packing import (pack_assignment,  # noqa: E402
                                            slot_capacity)
from repro_torch.sim import spec as tspec  # noqa: E402


@pytest.mark.parametrize("n,m,slots,seed", [(50, 3, 11, 0), (200, 12, 7, 1),
                                            (9, 4, 9, 2)])
def test_pack_assignment_matches_reference(n, m, slots, seed):
    rng = np.random.default_rng(seed)
    assign = rng.integers(-1, m, (2, n)).astype(np.int32)
    for s in range(2):            # at most `slots` clients per ES
        for j in range(m):
            idx = np.nonzero(assign[s] == j)[0]
            assign[s, idx[slots:]] = -1
    outcomes = (rng.random((2, n, m)) < 0.7).astype(np.float32)
    latency = rng.uniform(0.5, 5.0, (2, n, m)).astype(np.float32)
    got = pack_assignment(t_(assign), t_(outcomes), t_(latency), m, slots)
    for s in range(2):
        want = jax_pack(jnp.asarray(assign[s]), jnp.asarray(outcomes[s]),
                        jnp.asarray(latency[s]), m, slots)
        for w, g in zip(want, got):
            assert bitwise(w, g[s])


@pytest.mark.parametrize("preset", ["paper", "tiered-pricing",
                                    "metropolis-1k"])
def test_slot_capacity_bound(preset):
    js, ts = jsim.make(preset).spec, tspec.make(preset).spec
    assert ts.min_cost() == js.min_cost()
    budget = jsim.make(preset).cfg.budget
    assert slot_capacity(budget, ts.min_cost(), ts.num_clients) == \
        jax_capacity(budget, np.array([js.min_cost()]), js.num_clients)
