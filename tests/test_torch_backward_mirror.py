"""Algorithm notes for the two backward kernels, and the plumbing of the
three ``autograd.Function``s.

The mirrors below are a float64 numpy statement of each backward
kernel's algorithm, held against autograd through the plain versions on
the CPU. They check the algorithm as written here, not the ``.cu``
sources: nothing keeps the two in step, and an index, stride, layout or
argument slip in a kernel would leave them passing. The kernels' own
correctness rests on ``tests/test_torch_train_cuda.py`` and phase 27 of
``chip_smoke.py``, run on the card.

* B5's backward (``csrc/rwkv6_scan_bwd.cu``): checkpoints of the state
  every 64 steps on a forward walk, then per chunk (last first) the
  chunk's states recomputed from its checkpoint and the reverse steps
  (dr, dk, dv, dlog_w, du, the step of G) from the final state's
  gradient; ragged T, a strong decay, a nonzero final-state gradient.
* B4's backward (``csrc/flash_attention_bwd.cu``): each row's logsumexp
  online over 64-key tiles and Delta = rowsum(dO o O), dQ over the key
  tiles a query tile sees, each query head's share of dK and dV over
  the query tiles that see a key tile, then the shares summed over the
  group in head order; causal, windowed, non-causal, ragged S, GQA.

* The three ``autograd.Function``s (``FlashAttention``, ``Rwkv6Scan``,
  ``MoERouter``) with the CUDA wrappers stood in for by their plain
  versions: a reduced model's gradients through them equal plain
  autograd's.

The mirrors run in float64, the plain versions in float32 (they cast
their inputs): 1e-5 of each gradient's largest value (measured below
2e-6); a slip in the algorithm (a step, a tile or a mask off by one)
errs by O(1).
"""
import math

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
C = 64      # B5's checkpoint interval and chunk
TILE = 64   # B4's query and key tiles


def rwkv6_bwd_mirror(r, k, v, lw, u, dy, dfin):
    """r, k, v, lw, dy (B, H, T, 64); u (H, 64); dfin (B, H, 64, 64) or
    None -> dr, dk, dv, dlw (B, H, T, 64), du (H, 64)."""
    b, h, t, d = r.shape
    w = np.exp(lw)
    nc = -(-t // C)
    out = [np.zeros_like(r) for _ in range(4)]
    du_part = np.zeros((b, h, d))
    for bb in range(b):
        for hh in range(h):
            ckpt, state = [], np.zeros((d, d))
            for c in range(nc):                        # pass 1
                ckpt.append(state.copy())
                for m in range(c * C, min((c + 1) * C, t)):
                    state = w[bb, hh, m][:, None] * state \
                        + np.outer(k[bb, hh, m], v[bb, hh, m])
            g = np.zeros((d, d)) if dfin is None else dfin[bb, hh].copy()
            for c in range(nc - 1, -1, -1):            # pass 2
                t0, t1 = c * C, min((c + 1) * C, t)
                states, state = [], ckpt[c]
                for m in range(t0, t1):
                    states.append(state)
                    state = w[bb, hh, m][:, None] * state \
                        + np.outer(k[bb, hh, m], v[bb, hh, m])
                for m in range(t1 - 1, t0 - 1, -1):
                    prev = states[m - t0]
                    rr, kk, vv = r[bb, hh, m], k[bb, hh, m], v[bb, hh, m]
                    gy, ui = dy[bb, hh, m], u[hh]
                    vd = vv @ gy
                    out[0][bb, hh, m] = prev @ gy + ui * kk * vd
                    out[1][bb, hh, m] = g @ vv + rr * ui * vd
                    out[2][bb, hh, m] = g.T @ kk + (rr @ (ui * kk)) * gy
                    out[3][bb, hh, m] = w[bb, hh, m] * (g * prev).sum(1)
                    du_part[bb, hh] += rr * kk * vd
                    g = w[bb, hh, m][:, None] * g + np.outer(rr, gy)
    return (*out, du_part.sum(0))


def flash_bwd_mirror(q, k, v, o, do, causal, window):
    """q, o, do (B, H, S, D); k, v (B, KV, S, D) -> dq, dk, dv."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    group = h // kv
    scale = 1.0 / math.sqrt(d)
    nt = -(-s // TILE)

    def visible(qpos, kpos):
        ok = (kpos[None, :] < s) & (qpos[:, None] < s)
        if causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            ok &= kpos[None, :] > qpos[:, None] - window
        return ok

    def key_tiles(q0):
        last = min(nt, (q0 + TILE - 1) // TILE + 1) if causal else nt
        first = max(0, (q0 - window + 1) // TILE) if window > 0 else 0
        return range(first, last)

    def rows(x, r0):
        return x[r0:r0 + TILE]

    dq = np.zeros_like(q)
    lse = np.zeros((b, h, s))
    delta = (do * o).sum(-1)
    shares_k = np.zeros((b, h, s, d))
    shares_v = np.zeros((b, h, s, d))
    for bb in range(b):
        for hh in range(h):
            kh = hh // group
            qs, ks, vs = q[bb, hh] * scale, k[bb, kh], v[bb, kh]
            for qt in range(nt):                     # launch (1)
                q0 = qt * TILE
                qpos = np.arange(q0, min(q0 + TILE, s))
                m = np.full(len(qpos), -1e30)
                l = np.zeros(len(qpos))
                for it in key_tiles(q0):
                    kpos = np.arange(it * TILE, min(it * TILE + TILE, s))
                    sc = np.where(visible(qpos, kpos),
                                  rows(qs, q0) @ rows(ks, it * TILE).T,
                                  -1e30)
                    m_new = np.maximum(m, sc.max(1))
                    p = np.where(sc > -5e29, np.exp(sc - m_new[:, None]), 0)
                    l = np.exp(m - m_new) * l + p.sum(1)
                    m = m_new
                lse[bb, hh, qpos] = m + np.log(l)
                for it in key_tiles(q0):
                    kpos = np.arange(it * TILE, min(it * TILE + TILE, s))
                    sc = rows(qs, q0) @ rows(ks, it * TILE).T
                    p = np.where(visible(qpos, kpos),
                                 np.exp(sc - lse[bb, hh, qpos][:, None]), 0)
                    dp = rows(do[bb, hh], q0) @ rows(vs, it * TILE).T
                    ds = p * (dp - delta[bb, hh, qpos][:, None])
                    dq[bb, hh, qpos] += scale * ds @ rows(ks, it * TILE)
            for kt in range(nt):                     # launch (2)
                k0 = kt * TILE
                kpos = np.arange(k0, min(k0 + TILE, s))
                k_last = kpos[-1]
                first = k0 // TILE if causal else 0
                last = min(nt, (k_last + window - 1) // TILE + 1) \
                    if window > 0 else nt
                for qt in range(first, last):
                    qpos = np.arange(qt * TILE, min(qt * TILE + TILE, s))
                    sc = rows(qs, qt * TILE) @ rows(ks, k0).T
                    p = np.where(visible(qpos, kpos),
                                 np.exp(sc - lse[bb, hh, qpos][:, None]), 0)
                    dp = rows(do[bb, hh], qt * TILE) @ rows(vs, k0).T
                    ds = p * (dp - delta[bb, hh, qpos][:, None])
                    shares_v[bb, hh, kpos] += p.T @ rows(do[bb, hh],
                                                         qt * TILE)
                    shares_k[bb, hh, kpos] += ds.T @ rows(qs, qt * TILE)
    dk = shares_k.reshape(b, kv, group, s, d).sum(2)   # launch (3)
    dv = shares_v.reshape(b, kv, group, s, d).sum(2)
    return dq, dk, dv


def _autograd(fn, inputs, grads):
    xs = [torch.as_tensor(x).requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, torch.as_tensor(g)) for o, g in zip(outs, grads)
             if g is not None]
    torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
    # an input no output depends on (log_w at T = 1 without a final-state
    # gradient) takes none: zero
    return [np.zeros(x.shape) if x.grad is None else x.grad.numpy()
            for x in xs]


def _agree(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("t,w0,fin", [(64, -2.0, False), (100, -2.0, True),
                                      (130, 1.0, True), (1, -2.0, False)])
def test_rwkv6_bwd_algorithm_matches_autograd(t, w0, fin):
    rng = np.random.default_rng(t)
    b, h = 2, 2
    r, k, v = (rng.standard_normal((b, h, t, 64)) for _ in range(3))
    lw = -np.exp(0.5 * rng.standard_normal((b, h, t, 64)) + w0)
    u = 0.1 * rng.standard_normal((h, 64))
    dy = rng.standard_normal((b, h, t, 64))
    dfin = rng.standard_normal((b, h, 64, 64)) if fin else None
    got = rwkv6_bwd_mirror(r, k, v, lw, u, dy, dfin)
    want = _autograd(rwkv6_scan_ref, (r, k, v, lw, u), (dy, dfin))
    _agree(got, want)


@pytest.mark.parametrize("s,h,kv,d,causal,window", [
    (130, 4, 2, 16, True, 0), (200, 3, 1, 8, True, 64),
    (96, 2, 2, 8, False, 0), (150, 4, 1, 8, False, 70)])
def test_flash_bwd_algorithm_matches_autograd(s, h, kv, d, causal, window):
    rng = np.random.default_rng(s)
    b = 1
    q = rng.standard_normal((b, h, s, d))
    k, v = (rng.standard_normal((b, kv, s, d)) for _ in range(2))
    do = rng.standard_normal((b, h, s, d))
    o = attention_ref(*(torch.as_tensor(x) for x in (q, k, v)),
                      causal=causal, window=window).numpy()
    got = flash_bwd_mirror(q, k, v, o, do, causal, window)
    want = _autograd(lambda a, bb, c: attention_ref(a, bb, c, causal=causal,
                                                    window=window),
                     (q, k, v), (do,))
    _agree(got, want)


# -- the autograd.Functions' plumbing, with the kernels stood in for ------

def _fake_kernels(monkeypatch):
    """On the CPU: route the ops through their ``autograd.Function``s, with
    each CUDA wrapper replaced by its plain version in the kernel's
    layouts (outputs as views of the model's layout, as the kernels
    return them). What this checks is the Functions' plumbing: saved
    tensors, transposes, argument order, the gradients' dtypes."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.moe_router import kernel as mk
    from repro_torch.kernels.moe_router import ops as mo
    from repro_torch.kernels.moe_router.ref import moe_router_ref
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    from repro_torch.kernels.rwkv6_scan import ops as ro

    def as_model_layout(x):       # a (B, H, S, D) view of (B, S, H, D)
        return x.transpose(1, 2).contiguous().transpose(1, 2)

    def grads(fn, inputs, outs_grads):
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(True) for x in inputs]
            outs = fn(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, outs_grads) if g is not None]
            gs = torch.autograd.grad([o for o, _ in pairs], xs,
                                     [g for _, g in pairs], allow_unused=True)
        return [torch.zeros_like(x) if g is None else g
                for x, g in zip(xs, gs)]

    def fa(q, k, v, causal=True, window=0):
        common.count_launch("flash_attention")
        return as_model_layout(attention_ref(q, k, v, causal, window))

    def fa_bwd(q, k, v, o, do, causal=True, window=0):
        common.count_launch("flash_attention_bwd")
        return [as_model_layout(g) for g in grads(
            lambda a, b, c: attention_ref(a, b, c, causal, window),
            (q, k, v), (do,))]

    def scan(r, k, v, lw, u):
        common.count_launch("rwkv6_scan")
        y, fin = rwkv6_scan_ref(r, k, v, lw, u)
        return as_model_layout(y), fin

    def scan_bwd(r, k, v, lw, u, dy, dfin=None):
        common.count_launch("rwkv6_scan_bwd")
        g = grads(rwkv6_scan_ref, (r, k, v, lw, u), (dy, dfin))
        return (*(as_model_layout(x) for x in g[:4]), g[4])

    def router(logits, k):
        common.count_launch("moe_router")
        return moe_router_ref(logits, k)

    for mod in (fo, ro, mo):
        monkeypatch.setattr(mod, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(fk, "flash_attention_kernel", fa)
    monkeypatch.setattr(fk, "flash_attention_bwd_kernel", fa_bwd)
    monkeypatch.setattr(rk, "rwkv6_scan_kernel", scan)
    monkeypatch.setattr(rk, "rwkv6_scan_bwd_kernel", scan_bwd)
    monkeypatch.setattr(mk, "moe_router_kernel", router)
    common.reset_launches()
    return common.LAUNCHES


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-1.6b",
                                  "mixtral-8x22b"])
def test_autograd_functions_route_the_gradients(arch, monkeypatch):
    """A reduced model's loss gradients through the three Functions (the
    kernels stood in for by their plain versions) equal plain autograd's
    within 1e-5 of each leaf's largest value (the stand-ins sum the
    per-head and per-step terms in their own graphs, so float32 sums
    meet in another order, measured up to 6.5e-7; a wrong transpose or
    argument errs by O(1)),
    and each backward launches once a layer."""
    from repro_torch.configs import get_config
    from repro_torch.fed.distributed import value_and_grad
    from repro_torch.models import registry as R
    cfg = get_config(arch).reduced()
    params = R.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    w = torch.tensor([1.0, 0.5])
    want_l, want_g = value_and_grad(cfg, params, batch, w)
    launches = _fake_kernels(monkeypatch)
    got_l, got_g = value_and_grad(cfg, params, batch, w)
    bwd = "rwkv6_scan_bwd" if cfg.arch_type == "ssm" else "flash_attention_bwd"
    assert launches[bwd] == cfg.num_layers
    if cfg.arch_type == "moe":
        assert launches["moe_router"] == cfg.num_layers
    assert torch.equal(got_l, want_l)

    def flat(t):
        return [x for k in sorted(t) for x in
                (flat(t[k]) if isinstance(t[k], dict) else [t[k]])]
    for a, b in zip(flat(got_g), flat(want_g)):
        assert a.dtype == b.dtype
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-12)
