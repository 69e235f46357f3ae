"""Numerics of the port's LM training path: how far a reduced model's
float32 gradients move between routes, how accurate B5's backward kernel
is on a model's own scan inputs, and the loss over a few SGD steps at
full width for several learning rates. On the GPU:

    python3 tools/train_numerics.py [--arch ID ...] [--lrs 0.1,0.01]
    python3 tools/train_numerics.py --device cpu   # parts 1 and 2a only

1. Each ``--arch`` at ``reduced()`` (float32, TF32 off; 2 x 64 tokens
   from ``make_concrete_batch`` seed 1, weights (1, 0), as phase 27 of
   ``chip_smoke.py``): the loss and every gradient leaf of
   ``fed.distributed.value_and_grad`` on the CPU (the plain versions),
   (2a) on the CPU with the WKV scan's forward output rounded once from
   float64 (the conditioning of the gradients in that output), on CUDA
   through the kernels, and on CUDA through the plain versions (every
   op's route forced to its ``ref.py``). Each line: a leaf's largest
   value, the max abs gap, and the gap over that value.
2. For an ssm arch on CUDA: B5's backward kernel on the scan inputs and
   incoming gradient each layer of the reduced model saw, and on those
   of the full-width model's first and last layers (bf16), against
   autograd of the recurrence in float64; the float32 plain version's
   error beside it.
3. Each ``--arch`` at full width in bf16 (random weights, seed 0): the
   losses of 4 steps of ``make_train_step`` on one fixed 4 x 512 batch at
   each of ``--lrs``.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def flat(tree, prefix=""):
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += flat(tree[k], prefix + k + ".")
        else:
            out.append((prefix + k, tree[k]))
    return out


@contextlib.contextmanager
def plain_routes():
    """Every kernel op takes its plain version, whatever the device."""
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.moe_router import ops as mo
    from repro_torch.kernels.rwkv6_scan import ops as ro
    saved = [(m, m.on_cuda) for m in (fo, mo, ro)]
    for m, _ in saved:
        m.on_cuda = lambda *a: False
    try:
        yield
    finally:
        for m, f in saved:
            m.on_cuda = f


def recurrence64(r, k, v, lw, u):
    """y of the exclusive WKV recurrence with u, in float64."""
    r, k, v, lw, u = (x.double() for x in (r, k, v, lw, u))
    b, h, t, d = r.shape
    c = torch.zeros((b, h, d, d), dtype=torch.float64, device=r.device)
    ys = []
    for m in range(t):
        rm, km, vm = r[:, :, m], k[:, :, m], v[:, :, m]
        ys.append(torch.einsum("bhi,bhij->bhj", rm, c)
                  + (rm * u * km).sum(-1, keepdim=True) * vm)
        c = torch.exp(lw[:, :, m])[..., None] * c \
            + km[..., None] * vm[:, :, None, :]
    return torch.stack(ys, 2)


@contextlib.contextmanager
def scan_rounded_once():
    """The scan's forward output computed in float64 and rounded once
    (its backward stays the plain version's)."""
    import repro_torch.models.layers as L
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    class Scan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, lw, u):
            ctx.save_for_backward(r, k, v, lw, u)
            _, fin = rwkv6_scan_ref(r, k, v, lw, u)
            return recurrence64(r, k, v, lw, u).float(), fin

        @staticmethod
        def backward(ctx, dy, dfin):
            xs = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
            with torch.enable_grad():
                y, fin = rwkv6_scan_ref(*xs)
                pairs = [(o, g) for o, g in ((y, dy), (fin, dfin))
                         if g is not None]
                return torch.autograd.grad([o for o, _ in pairs], xs,
                                           [g for _, g in pairs])

    real = L.rwkv6_scan
    L.rwkv6_scan = Scan.apply
    try:
        yield
    finally:
        L.rwkv6_scan = real


def compare(what, got, want):
    for (name, a), (_, b) in zip(flat(got), flat(want)):
        a, b = a.float().cpu(), b.float().cpu()
        top = b.abs().max().item()
        gap = (a - b).abs().max().item()
        print(f"  {what} {name}: max {top:.3e}, gap {gap:.3e} "
              f"({gap / max(top, 1e-30):.2e} of it), finite "
              f"{bool(torch.isfinite(a).all())}")


def reduced_gaps(arch, dev):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.fed.distributed import value_and_grad
    from repro_torch.models import registry as R
    cfg = get_config(arch).reduced()
    params = R.init_params(cfg, 0, device="cpu")
    batch = R.make_concrete_batch(cfg, InputShape("train", 64, 2, "train"),
                                  seed=1, device="cpu")
    w = torch.tensor([1.0, 0.0])
    loss, cpu = value_and_grad(cfg, params, batch, w)
    print(f"{arch} reduced: CPU loss {float(loss):.7f}")
    if cfg.arch_type == "ssm":
        with scan_rounded_once():
            loss1, once = value_and_grad(cfg, params, batch, w)
        print(f"{arch} reduced: CPU, scan output rounded once: loss "
              f"{float(loss1):.7f}")
        compare(f"{arch} rounded-once-vs-CPU", once, cpu)
    if dev.type != "cuda":
        return
    to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) \
        else t.to(dev)
    pd, bd, wd = to(params), to(batch), w.to(dev)
    loss_k, kern = value_and_grad(cfg, pd, bd, wd)
    with plain_routes():
        loss_p, plain = value_and_grad(cfg, pd, bd, wd)
    print(f"{arch} reduced: CUDA kernels loss {float(loss_k):.7f}, CUDA "
          f"plain loss {float(loss_p):.7f}")
    compare(f"{arch} kernels-vs-CPU", kern, cpu)
    compare(f"{arch} plain-CUDA-vs-CPU", plain, cpu)
    compare(f"{arch} kernels-vs-plain-CUDA", kern, plain)


def scan_bwd_on_model_inputs(arch, dev, full: bool, layers=None):
    """Part 2 for one model: each captured layer's scan inputs and dy."""
    import repro_torch.models.layers as L
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.fed.distributed import value_and_grad
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_bwd_kernel
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    from repro_torch.models import registry as R
    cfg = get_config(arch) if full else get_config(arch).reduced()
    params = R.init_params(cfg, 0, device=dev)
    shape = (4, 512) if full else (2, 64)
    batch = R.make_concrete_batch(
        cfg, InputShape("train", shape[1], shape[0], "train"), seed=1,
        device=dev)
    w = torch.ones(shape[0], device=dev)
    caught, real = [], L.rwkv6_scan
    keep = set(range(cfg.num_layers) if layers is None else layers)

    def spy(r, k, v, lw, u):
        y, fin = real(r, k, v, lw, u)
        if len(caught) in keep:
            rec = {"in": [x.detach() for x in (r, k, v, lw, u)]}
            y.register_hook(lambda g: rec.__setitem__("dy", g))
        else:
            rec = None
        caught.append(rec)
        return y, fin

    L.rwkv6_scan = spy
    try:
        value_and_grad(cfg, params, batch, w)
    finally:
        L.rwkv6_scan = real
    del params
    for li, rec in enumerate(caught):
        if rec is None:
            continue
        r, k, v, lw, u = rec["in"]
        dy = rec.pop("dy")
        got = rwkv6_scan_bwd_kernel(r, k, v, lw, u,
                                    dy if dy.stride(-1) == 1
                                    else dy.contiguous())
        xs = [x.double().requires_grad_(True) for x in (r, k, v, lw, u)]
        want = torch.autograd.grad(recurrence64(*xs), xs, dy.double())
        x32 = [x.float().requires_grad_(True) for x in (r, k, v, lw, u)]
        y32, _ = rwkv6_scan_ref(*x32)
        plain = torch.autograd.grad(y32, x32, dy)
        for name, g, w64, p in zip(("r", "k", "v", "log_w", "u"), got, want,
                                   plain):
            top = w64.abs().max().item()
            e = (g.double() - w64).abs().max().item()
            ep = (p.double() - w64).abs().max().item()
            print(f"  {arch} {'full' if full else 'reduced'} layer {li} "
                  f"d{name} ({r.dtype}): max {top:.3e}; kernel "
                  f"{e / top:.2e} of it, float32 plain {ep / top:.2e}")
        del xs, want, x32, y32, plain, got
        torch.cuda.empty_cache()


def full_width_lrs(arch, dev, lrs):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.fed.distributed import make_train_step
    from repro_torch.models import registry as R
    cfg = get_config(arch)
    params = R.init_params(cfg, 0, device=dev)
    b = TokenStream(cfg.vocab_size, 512, 4, seed=0).sample(
        np.random.default_rng(0))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    w = torch.ones(4, device=dev)
    for lr in lrs:
        step, p, losses = make_train_step(cfg, lr=lr), params, []
        for _ in range(4):
            p, loss = step(p, batch, w)
            losses.append(float(loss))
        print(f"{arch} full width bf16, lr {lr}: losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}")
        del p
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*",
                    default=["rwkv6-1.6b", "qwen2-1.5b"])
    ap.add_argument("--lrs", default="0.1,0.03,0.01,0.003")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    if dev.type == "cuda":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    from repro_torch.configs import get_config
    for arch in args.arch:
        reduced_gaps(arch, dev)
    if dev.type != "cuda":
        return 0
    for arch in args.arch:
        if get_config(arch).arch_type == "ssm":
            scan_bwd_on_model_inputs(arch, dev, full=False)
            last = get_config(arch).num_layers - 1
            scan_bwd_on_model_inputs(arch, dev, full=True,
                                     layers=(0, last))
    lrs = [float(x) for x in args.lrs.split(",")]
    for arch in args.arch:
        full_width_lrs(arch, dev, lrs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
