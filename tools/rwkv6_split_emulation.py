"""Emulates, on the CPU, the operand rounding of B5's chunked tensor-core
kernel (``src/repro_torch/csrc/rwkv6_scan.cu``) and prints its error
against a float64 per-step recurrence:

    PYTHONPATH=src python3 tools/rwkv6_split_emulation.py [--heads 8]

The chunked algorithm is the kernel's (chunks of 64, sub-chunks of 16,
decays referenced so that no factor exceeds 1), with the scores inside a
sub-chunk taken pairwise and rounded once to float32 (the kernel splits
them at the sub-chunk's halves, the same function in exact arithmetic). Each of its four products rounds
its operands as the kernel would: ``exact`` (float64), ``bf16`` (an
inexact operand split into two bf16 halves, 16 bits), ``tf32`` (hi
rounded to TF32, lo = x - hi truncated to TF32 as the tensor core reads
it, 21-22 bits) or ``bf16x3`` (three bf16 pieces, 24 bits, against the
exact bf16 v). The kernel takes tf32 for q S and the scores and bf16x3
for A V and k^T V; bf16 r, k and v are exact in one operand of either
type. The products sum in float64 and round once
to float32, so this measures the operands' rounding, not the tensor
cores' accumulation order. Inputs as ``chip_smoke.py`` phase 7 makes
them: r, k, v bf16 N(0, 1), log_w = -exp(0.5 N + w0), u 0.1 N, T = 512.
"""
from __future__ import annotations

import argparse

import torch

F64 = torch.float64


def _bf16(x):
    return x.to(torch.float32).to(torch.bfloat16).to(F64)


def _tf32(x):
    """float32 -> TF32, round to nearest, ties away (``cvt.rna``, or the
    kernel's integer add and mask)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32).to(F64)


def _tf32_trunc(x):
    """float32 -> TF32 by dropping the low 13 bits, as the tensor core
    reads a float32 register given as a TF32 operand."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return (i & ~0x1FFF).view(torch.float32).to(F64)


def _mm(a, b, mode, exact_b=False):
    """a @ b with a split (and b split unless ``exact_b``) as ``mode``
    says: hi.hi + hi.lo + lo.hi, rounded once to float32; ``bf16x3``
    splits a into three bf16 pieces against an exact b."""
    if mode == "exact":
        return a @ b
    if mode == "bf16x3":
        assert exact_b
        a32 = a.to(torch.float32).to(F64)
        p0 = _bf16(a32)
        p1 = _bf16(a32 - p0)
        p2 = _bf16(a32 - p0 - p1)
        return ((p0 + p1 + p2) @ b).to(torch.float32).to(F64)
    rnd = _bf16 if mode == "bf16" else _tf32
    low = _tf32_trunc if mode == "tf32" else rnd   # lo as the kernel passes it
    ah = rnd(a)
    al = low(a.to(torch.float32).to(F64) - ah)
    bh = rnd(b)
    out = ah @ bh + al @ bh
    if not exact_b:
        out = out + ah @ low(b.to(torch.float32).to(F64) - bh)
    return out.to(torch.float32).to(F64)


def chunked(r, k, v, lw, u, modes, chunk=64, sub=16):
    """``modes``: the rounding of the state product (q S), the
    off-diagonal scores, A V and the state update (k^T V)."""
    b, h, t, d = r.shape
    r, k, v, lw, u = (x.to(F64) for x in (r, k, v, lw, u))
    n = -(-t // chunk)
    pad = (0, 0, 0, n * chunk - t)
    r, k, v, lw = (torch.nn.functional.pad(x, pad) for x in (r, k, v, lw))
    ns = chunk // sub
    i_ = torch.arange(sub)
    below = (i_[:, None] > i_[None, :])[..., None]
    diag = (i_[:, None] == i_[None, :])[..., None]
    state = torch.zeros((b, h, d, d), dtype=F64)
    ys = []
    for c in range(n):
        rows = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc = r[:, :, rows], k[:, :, rows], v[:, :, rows]
        w = lw[:, :, rows].reshape(b, h, ns, sub, d)
        incl = torch.cumsum(w, 3)
        e = incl - w
        tot = incl[:, :, :, -1]
        g = tot[:, :, :, None] - incl
        qt = rc.reshape(b, h, ns, sub, d) * torch.exp(e)
        kt = kc.reshape(b, h, ns, sub, d) * torch.exp(g)
        a = torch.zeros((b, h, chunk, chunk), dtype=F64)
        y = torch.zeros((b, h, chunk, d), dtype=F64)
        for si in range(ns):
            ri = slice(si * sub, (si + 1) * sub)
            before = torch.exp(tot[:, :, :si].sum(2))[:, :, None]
            y[:, :, ri] = _mm(qt[:, :, si] * before, state, modes[0])
            for sj in range(si):
                mid = torch.exp(tot[:, :, sj + 1:si].sum(2))[:, :, None]
                a[:, :, ri, sj * sub:(sj + 1) * sub] = _mm(
                    qt[:, :, si], (kt[:, :, sj] * mid).transpose(-1, -2),
                    modes[1])
            pair = e[:, :, si, :, None] - incl[:, :, si, None]
            fac = torch.where(below, torch.exp(torch.where(below, pair,
                                                             0.0)), 0.0)
            fac = fac + torch.where(diag, u[None, :, None, None], 0.0)
            blk = torch.einsum("bhic,bhjc,bhijc->bhij", rc[:, :, ri],
                               kc[:, :, ri], fac)
            a[:, :, ri, ri] = blk.to(torch.float32).to(F64)
        ys.append(y + _mm(a, vc, modes[2], exact_b=True))
        after = torch.flip(torch.cumsum(torch.flip(tot, (2,)), 2), (2,)) \
            - tot
        kh = (kt * torch.exp(after)[:, :, :, None]).reshape(b, h, chunk, d)
        state = state * torch.exp(tot.sum(2))[..., None] \
            + _mm(kh.transpose(-1, -2), vc, modes[3], exact_b=True)
    return torch.cat(ys, 2)[:, :, :t], state


def per_step(r, k, v, lw, u):
    r, k, v, lw, u = (x.to(F64) for x in (r, k, v, lw, u))
    b, h, t, d = r.shape
    state = torch.zeros((b, h, d, d), dtype=F64)
    ys = []
    for i in range(t):
        rt, kt, vt = r[:, :, i], k[:, :, i], v[:, :, i]
        ys.append(torch.einsum("bhd,bhdv->bhv", rt, state)
                  + torch.einsum("bhd,hd,bhd->bh", rt, u, kt)[..., None]
                  * vt)
        state = state * torch.exp(lw[:, :, i])[..., None] \
            + kt[..., None] * vt[..., None, :]
    return torch.stack(ys, 2), state


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    gen = torch.Generator().manual_seed(args.seed)
    b, h, t = 1, args.heads, 512
    products = ("q S", "scores", "A V", "k^T V")
    trials = [("exact",) * 4, ("bf16",) * 4, ("tf32",) * 4,
              ("tf32", "tf32", "bf16x3", "bf16x3")]
    trials += [tuple("bf16" if i == j else "tf32" for i in range(4))
               for j in range(4)]
    for w0 in (-2.0, 0.0, 1.0, 3.0):
        r, k, v = (torch.randn((b, h, t, 64), generator=gen)
                   .to(torch.bfloat16).float() for _ in range(3))
        lw = -torch.exp(torch.randn((b, h, t, 64), generator=gen) * 0.5
                        + w0)
        u = torch.randn((h, 64), generator=gen) * 0.1
        wy, wf = per_step(r, k, v, lw, u)
        for modes in trials:
            y, f = chunked(r, k, v, lw, u, modes)
            ey = ((y - wy).abs() / wy.abs().clamp(min=1)).max().item()
            ef = ((f - wf).abs() / wf.abs().clamp(min=1)).max().item()
            label = ", ".join(f"{p} {m}" for p, m in zip(products, modes))
            print(f"w0 {w0:+.1f} ({label}): y {ey:.3e}, final state "
                  f"{ef:.3e} of max(1, |value|); values up to "
                  f"{wy.abs().max().item():.1f}")


if __name__ == "__main__":
    main()
