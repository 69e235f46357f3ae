"""The backward kernels of the training path on the card, against
autograd through their plain versions (``ref.py``) on the same inputs in
float32: B4's (``flash_attention_bwd``), B5's (``rwkv6_scan_bwd``) and
B6's gate gradient (``ops.MoERouter``); and a reduced model's training
step on the card against the CPU. These need an NVIDIA GPU (and nvcc);
on a machine without one they skip. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Tolerances, each error over the gradient's largest reference value:
float32 inputs 1e-4 (float32 sums in another order); bf16 inputs 2^-7
(the gradients are rounded once to bf16, 2^-8 of a value, and B4 reads
the forward's bf16 output for rowsum(dO o O)).
"""
import pytest
import torch

from repro_torch.kernels import common

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(got, want) -> float:
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp(min=1e-12))


def _ref_grads(fn, inputs, grads_out):
    """Autograd through ``fn`` on float32 copies of ``inputs``."""
    xs = [x.detach().float().requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(
        [o for o, g in zip(outs, grads_out) if g is not None],
        [g.float() for g in grads_out if g is not None])
    return [x.grad for x in xs]


@pytest.mark.parametrize("b,s,h,kv,d,dtype,causal,window", [
    (2, 128, 4, 4, 64, torch.float32, True, 0),
    (2, 100, 6, 1, 64, torch.float32, True, 64),
    (1, 96, 8, 1, 128, torch.float32, False, 0),
    (2, 128, 4, 2, 64, torch.bfloat16, True, 0),
    (1, 200, 8, 1, 128, torch.bfloat16, True, 64),
    (2, 64, 4, 4, 128, torch.bfloat16, False, 0)])
def test_flash_attention_bwd_matches_autograd(dev, b, s, h, kv, d, dtype,
                                              causal, window):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device=dev).manual_seed(s + h)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    do = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    common.reset_launches()
    out = flash_attention(*xs, causal=causal, window=window)
    out.backward(do)
    assert common.LAUNCHES["flash_attention"] == 1
    assert common.LAUNCHES["flash_attention_bwd"] == 1
    want = _ref_grads(
        lambda a, bb, c: attention_ref(a.transpose(1, 2), bb.transpose(1, 2),
                                       c.transpose(1, 2), causal=causal,
                                       window=window).transpose(1, 2),
        (q, k, v), (do,))
    for x, w in zip(xs, want):
        assert x.grad.dtype == dtype and x.grad.shape == w.shape
        assert torch.isfinite(x.grad).all()
        assert _rel(x.grad, w) <= TOL[dtype]


def test_flash_attention_bwd_refuses_other_head_dims(dev):
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bwd_kernel
    q = torch.zeros((1, 2, 8, 32), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd_kernel(q, q, q, q, q)


@pytest.mark.parametrize("b,h,t,w0,dtype,fin", [
    (2, 3, 64, -2.0, torch.float32, False),
    (1, 2, 100, -2.0, torch.float32, True),
    (2, 2, 128, 1.0, torch.float32, True),
    (2, 3, 130, -2.0, torch.bfloat16, False),
    (1, 2, 64, 1.0, torch.bfloat16, True)])
def test_rwkv6_scan_bwd_matches_autograd(dev, b, h, t, w0, dtype, fin):
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    gen = torch.Generator(device=dev).manual_seed(t + h)
    shape = (b, t, h, 64)           # the model's layout, passed as views
    r, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    lw = -torch.exp(torch.randn(shape, generator=gen, device=dev) * 0.5 + w0)
    u = torch.randn((h, 64), generator=gen, device=dev) * 0.1
    dy = torch.randn((b, h, t, 64), generator=gen, device=dev)
    dfin = (torch.randn((b, h, 64, 64), generator=gen, device=dev)
            if fin else None)
    views = [a.transpose(1, 2) for a in (r, k, v, lw)]
    xs = [x.detach().requires_grad_(True) for x in views + [u]]
    common.reset_launches()
    y, final = rwkv6_scan(*xs)
    torch.autograd.backward([y] + ([final] if fin else []),
                            [dy] + ([dfin] if fin else []))
    assert common.LAUNCHES["rwkv6_scan"] == 1
    assert common.LAUNCHES["rwkv6_scan_bwd"] == 1
    want = _ref_grads(rwkv6_scan_ref, views + [u], (dy, dfin))
    for x, w in zip(xs, want):
        assert x.grad.dtype == x.dtype and x.grad.shape == w.shape
        assert torch.isfinite(x.grad).all()
        tol = TOL[dtype] if x.dtype == torch.bfloat16 else TOL[torch.float32]
        assert _rel(x.grad, w) <= tol


@pytest.mark.parametrize("t,e,k,ties", [(64, 8, 2, False), (50, 384, 8, False),
                                        (32, 16, 4, True)])
def test_moe_router_gate_grad_matches_autograd(dev, t, e, k, ties):
    from repro_torch.kernels.moe_router.ops import moe_router
    from repro_torch.kernels.moe_router.ref import moe_router_ref
    gen = torch.Generator(device=dev).manual_seed(e)
    logits = torch.randn((t, e), generator=gen, device=dev)
    if ties:
        logits = torch.round(logits * 2) / 2   # exact ties in every row
    dg = torch.randn((t, k), generator=gen, device=dev)
    x = logits.clone().requires_grad_(True)
    common.reset_launches()
    gates, idx = moe_router(x, k)
    gates.backward(dg)
    assert common.LAUNCHES["moe_router"] == 1
    xr = logits.clone().requires_grad_(True)
    wg, wi = moe_router_ref(xr, k)
    assert torch.equal(idx, wi)
    wg.backward(dg)
    assert float((x.grad - xr.grad).abs().max()) <= 1e-6


# a reduced model's SGD step (lr 0.1), CPU against CUDA: the parameters
# within 1e-4; the ssm's (rwkv6) within 2e-3, lr times phase 27's 2e-2 on
# its gradients, which move with the rounding of the WKV scan's output
# (the embedding's by 1.34e-3 when that output is rounded once from
# float64 on the CPU: tools/train_numerics.py)
STEP_TOL = {"ssm": 2e-3}


def test_reduced_train_step_cpu_against_cuda(dev):
    from repro_torch.configs import get_config
    from repro_torch.fed.distributed import make_train_step
    from repro_torch.models import registry as R
    for arch in ("qwen2-1.5b", "rwkv6-1.6b", "mixtral-8x22b"):
        cfg = get_config(arch).reduced()
        params = R.init_params(cfg, 0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        w = torch.tensor([1.0, 0.0])
        step = make_train_step(cfg, lr=0.1)
        want_p, want_l = step(params, batch, w)
        common.reset_launches()
        got_p, got_l = step({kk: _to(vv, dev) for kk, vv in params.items()},
                            {kk: vv.to(dev) for kk, vv in batch.items()},
                            w.to(dev))
        assert abs(float(got_l) - float(want_l)) <= 1e-4
        kern = {"ssm": "rwkv6_scan_bwd"}.get(cfg.arch_type,
                                             "flash_attention_bwd")
        assert common.LAUNCHES[kern] == cfg.num_layers
        tol = STEP_TOL.get(cfg.arch_type, 1e-4)
        for a, b in zip(_flat(got_p), _flat(want_p)):
            assert float((a.cpu() - b).abs().max()) <= tol


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]
