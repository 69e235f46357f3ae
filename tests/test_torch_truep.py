"""Analytic ``true_p`` (the exact Eq. 6 integral, ``sim/truep.py``)
against the reference on the CPU: the port's float32 form within
``JIT_TOL`` of the jitted reference and within ``F64_TOL`` of its
float64 numpy form (the reference's own bound against it), on the
pairs of ``paper`` and ``metropolis-1k`` rounds; and ``round_batch`` in
analytic mode, whose every field but ``true_p`` is bitwise ``mc``
mode's (the draws are addressed by tag)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import bitwise, one_torch_thread  # noqa: E402,F401
from repro.sim.truep import analytic_true_p as jax_true_p  # noqa: E402
from repro_torch.core.network import es_positions  # noqa: E402
from repro_torch.kernels.context_pairwise.ops import \
    pairwise_context  # noqa: E402
from repro_torch.sim import spec as tspec  # noqa: E402
from repro_torch.sim.core import (init_statics, round_batch,  # noqa
                                  sim_round)
from repro_torch.sim.truep import analytic_true_p  # noqa: E402

# float32 against the jitted reference: both evaluate 64 nodes of
# float32 transcendentals and sum them in their own order
JIT_TOL = 1e-5
# against the float64 numpy form (tests/test_kernel_context_parity.py)
F64_TOL = 1e-4

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pairs(preset, seeds=(0, 3), t=2):
    """The (bandwidth, compute, g0) of round ``t`` of ``preset``, from the
    port's simulator, as float32 numpy (the analytic mode's round draws
    no Monte-Carlo pairs)."""
    spec = tspec.make(preset, true_p="analytic").spec
    s = torch.tensor(seeds)
    st = init_statics(spec, s)
    pos = st.pos0
    for tt in range(t + 1):
        pos, sr = sim_round(spec, s, st, pos, tt)
    es = torch.as_tensor(es_positions(spec.num_edge_servers),
                         dtype=torch.float32)
    ones = torch.ones(pos.shape[:-1] + (spec.num_edge_servers,))
    # g0 depends on the positions alone (the fading is a dummy here)
    _, g0, _, _ = pairwise_context(
        pos, es, sr.bandwidth, sr.compute, ones, ones, tx_w=spec.tx_w,
        noise_psd_w=spec.noise_psd_w, update_bits=spec.update_bits,
        workload=spec.workload)
    return spec, sr.bandwidth.numpy(), sr.compute.numpy(), g0.numpy()


@pytest.mark.parametrize("preset", ["paper", "metropolis-1k"])
def test_analytic_true_p_against_reference(preset):
    spec, bw, comp, g0 = _pairs(preset)
    kw = dict(tx_w=spec.tx_w, noise_psd_w=spec.noise_psd_w,
              update_bits=spec.update_bits, workload=spec.workload,
              deadline_s=spec.deadline_s)
    got = analytic_true_p(torch.from_numpy(bw)[..., None],
                          torch.from_numpy(comp)[..., None],
                          torch.from_numpy(g0), **kw).numpy()
    jitted = jax.jit(jax.vmap(lambda b, c, g: jax_true_p(
        b[:, None], c[:, None], g, xp=jnp, **kw)))
    want = np.asarray(jitted(bw, comp, g0))
    f64 = np.stack([jax_true_p(bw[i, :, None].astype(np.float64),
                               comp[i, :, None].astype(np.float64),
                               g0[i].astype(np.float64), xp=np, **kw)
                    for i in range(bw.shape[0])])
    err_jit = float(np.abs(got - want).max())
    err_f64 = float(np.abs(got - f64).max())
    print(f"{preset}: max |port - jitted| {err_jit:.3e}, "
          f"|port - float64| {err_f64:.3e}")
    assert got.shape == g0.shape and got.dtype == np.float32
    assert np.isfinite(got).all() and (got >= 0).all() and (got <= 1).all()
    assert err_jit <= JIT_TOL
    assert err_f64 <= F64_TOL
    # a spread of probabilities, not a saturated table
    assert (got > 0.05).any() and (got < 0.95).any()


@pytest.mark.parametrize("preset", ["paper", "flash-crowd", "metropolis-1k"])
def test_round_batch_analytic_leaves_other_fields(preset):
    seeds = torch.tensor([0, 1])
    out = {}
    for mode in ("mc", "analytic"):
        spec = tspec.make(preset, true_p=mode).spec
        st = init_statics(spec, seeds)
        pos, rds = st.pos0, []
        for t in range(2):
            pos, rd = round_batch(spec, seeds, st, pos, t)
            rds.append(rd)
        out[mode] = (pos, rds)
    assert bitwise(out["mc"][0], out["analytic"][0])
    for a, b in zip(out["mc"][1], out["analytic"][1]):
        for f in a._fields:
            if f != "true_p":
                assert bitwise(getattr(a, f), getattr(b, f)), f
        # the two estimators agree to the Monte-Carlo noise of 128 pairs
        assert float((a.true_p - b.true_p).abs().mean()) < 0.05


def test_true_p_mode_is_checked():
    with pytest.raises(ValueError, match="true_p"):
        tspec.make("paper", true_p="exact")
    assert tspec.make("paper", true_p="analytic").spec.true_p == "analytic"
