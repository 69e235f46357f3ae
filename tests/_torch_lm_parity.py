"""Shared helpers of the LM parity tests (``test_torch_lm*.py``,
``test_torch_zamba2.py``, ``test_torch_encdec.py``, ``test_torch_vlm.py``):
the reference's serve flows driven on given inputs, and the checks that
hold the port's logits and tokens against them. Imports JAX; the caller
has already skipped when it is missing."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from _torch_parity import np_
from repro.models import registry as JR

MARGIN_FACTOR = 20.0


def tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def embeds(b, n, d, seed):
    """Frame or patch embeddings (B, n, d), standard normal float32."""
    return np.random.default_rng(seed).standard_normal((b, n, d)).astype(
        np.float32)


def check_greedy(got_logits, want_logits):
    """Greedy tokens equal, with the lead of the reference's top-1 over its
    runner-up larger than MARGIN_FACTOR x the largest logit gap. Returns
    the smallest lead."""
    want = np.asarray(want_logits, np.float64)
    got = np_(got_logits).astype(np.float64)
    top2 = np.sort(want, axis=-1)[..., -2:]
    lead = float((top2[..., 1] - top2[..., 0]).min())
    gap = float(np.abs(got - want).max())
    assert lead > MARGIN_FACTOR * gap, (lead, gap)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    return lead


def jax_serve_flow(cfg, params, prompt, gen_len, extra=None,
                   jit_rebuild=False):
    """The reference's ``launch/serve.py`` flow with given parameters,
    prompt and (``extra``) frames or patches: (prefill logits, logits that
    chose token 1, each decode step's logits, greedy tokens). The
    launcher rebuilds a recurrent state with ``serve_step`` un-jitted;
    ``jit_rebuild`` runs the same steps jitted (faster)."""
    b, pl = prompt.shape
    state = JR.init_serve_state(cfg, b, pl + gen_len)
    batch = {"tokens": prompt, **(extra or {})}
    prefill_logits, state = JR.prefill(params, cfg, batch, state)
    logits = prefill_logits
    step = jax.jit(lambda p, t, s: JR.serve_step(p, cfg, t, s))
    if cfg.arch_type in ("ssm", "hybrid"):
        state = JR.init_serve_state(cfg, b, pl + gen_len)
        rebuild = step if jit_rebuild else \
            (lambda p, t, s: JR.serve_step(p, cfg, t, s))
        for i in range(pl):
            logits, state = rebuild(params, prompt[:, i:i + 1], state)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out, steps = [tok], []
    for _ in range(gen_len - 1):
        sl, state = step(params, tok, state)
        steps.append(sl[:, -1])
        tok = jnp.argmax(sl[:, -1:], axis=-1).astype(jnp.int32)
        out.append(tok)
    return (prefill_logits, logits, jnp.stack(steps),
            jnp.concatenate(out, axis=1))


# The reference's engine (``repro.serving``) is quarantined: no module or
# test outside its own may import it
# (``tests/test_deprecated_entry_points.py``). So the port's engine is
# held against what the reference's engine computes, from the reference's
# registry: greedy decoding of each request alone from a fresh state, its
# prompt fed token by token ("prefill as decode"); batch rows do not
# interact. Its slot reset is held against the reference's rule
# (``src/repro/serving/engine.py:91-105``), transcribed below.


def reference_decode_alone(cfg, params, prompt, max_tokens, max_len):
    """One request through the reference's ``serve_step``, as its engine
    serves it in a slot of its own."""
    step = jax.jit(lambda p, t, s: JR.serve_step(p, cfg, t, s))
    state = JR.init_serve_state(cfg, 1, max_len)
    out = []
    for tok in prompt:
        logits, state = step(params, jnp.asarray([[tok]], jnp.int32), state)
    while True:
        out.append(int(jnp.argmax(logits[0, -1])))
        if len(out) == max_tokens:
            return out
        logits, state = step(params, jnp.asarray([[out[-1]]], jnp.int32),
                             state)


def reference_reset(state, fresh, b, i):
    """The reference's ``ServingEngine._reset_slot_state`` rule: on each
    field, the first axis whose length equals the slot count b."""
    out = {}
    for k, cur in state.items():
        cur = np.array(cur, copy=True)
        for axis in range(cur.ndim):
            if cur.shape[axis] == b:
                idx = [slice(None)] * cur.ndim
                idx[axis] = i
                cur[tuple(idx)] = np.asarray(fresh[k])[tuple(idx)]
                break
        out[k] = cur
    return out


def random_state(state, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in state.items():
        a = np_(v)
        if a.dtype.kind == "i":
            out[k] = rng.integers(0, 9, a.shape).astype(a.dtype)
        else:
            out[k] = rng.standard_normal(a.shape).astype(a.dtype)
    return out


def engine_matches_reference(tc, tp, jc, jp, engine_cls, seed=6):
    """3 slots, 5 requests of 2-7 prompt tokens: slots are refilled and
    reset; every request's tokens equal the reference's decoding of it."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, jc.vocab_size, n).tolist()
               for n in (3, 7, 2, 5, 4)]
    engine = engine_cls(tc, tp, batch_slots=3, max_len=16)
    reqs = [engine.submit(p, max_tokens=4) for p in prompts]
    finished = engine.run()
    assert sorted(r.uid for r in finished) == [1, 2, 3, 4, 5]
    for req, prompt in zip(reqs, prompts):
        assert req.done and len(req.output) == 4
        assert req.output == reference_decode_alone(jc, jp, prompt, 4, 16)
    assert engine.stats["tokens_out"] == 20


def init_tree_matches_reference(jc, tc):
    """The port's ``init_params`` tree has the reference's paths, shapes
    and dtypes (the numbers differ: torch's generator, JAX's scales), and
    is seeded."""
    import torch
    from repro_torch.models import registry as R
    want = jax.eval_shape(lambda k: JR.init_params(jc, k),
                          jax.random.PRNGKey(0))
    got = R.init_params(tc, 3, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    again = R.init_params(tc, 3, device="cpu")
    assert torch.equal(got["embed"], again["embed"])


def slot_reset_matches_reference(tc, registry, engine_cls, params,
                                 slots=3):
    """R6: at a slot count that no other state axis has, resetting slot i
    is the reference's rule, and only slot i's lanes change."""
    engine = engine_cls(tc, params, batch_slots=slots, max_len=16)
    start = random_state(engine.state, seed=7)
    from repro_torch.models.convert import lm_params_from_jax
    engine.state = lm_params_from_jax(start, "cpu")
    engine._reset_slot_state(1)
    fresh = registry.init_serve_state(tc, slots, 16, device="cpu")
    want = reference_reset(start, fresh, slots, 1)
    for k in start:
        np.testing.assert_array_equal(np_(engine.state[k]), want[k])
    axes = registry.state_batch_axes(tc)
    assert set(axes) == set(start)
    for k in start:
        lanes = np.moveaxis(np_(engine.state[k]), axes[k], 0)
        np.testing.assert_array_equal(
            lanes[1], np.moveaxis(np_(fresh[k]), axes[k], 0)[1])
        keep = [i for i in range(slots) if i != 1]
        np.testing.assert_array_equal(
            lanes[keep], np.moveaxis(start[k], axes[k], 0)[keep])
