"""The LM zoo's new uses of the card: B4 without the causal mask at the
new group sizes, the MoE combine's pinned order at k = 8, and zamba2's
chunked SSD form at its own chunk of 128. These need an NVIDIA GPU (and
nvcc to build the kernels at first use); on a machine without one they
skip. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_zoo_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels import common

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# B4's tolerance, as in test_torch_kernels_cuda.py: float32 1e-5; bf16
# one bf16 ulp of values below 4, 2 ** -6
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,kv,d", [
    (2, 256, 40, 8, 128),      # qwen2.5-14b's group of 5
    (2, 256, 48, 1, 128),      # granite-20b's MQA, a group of 48
    (2, 1024, 16, 16, 64),     # the seamless encoder's (batch cut to 2)
])
def test_flash_attention_not_causal(dev, b, s, h, kv, d, dtype):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device=dev).manual_seed(s + h)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    before = common.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=False)
    assert common.LAUNCHES["flash_attention"] == before + 1
    f32 = torch.float32
    want = attention_ref(*(a.transpose(1, 2).to(f32) for a in (q, k, v)),
                         causal=False).transpose(1, 2)
    tol = 1e-5 if dtype == f32 else 2 ** -6
    torch.testing.assert_close(got.to(f32), want, rtol=tol, atol=tol)
    causal = attention_ref(*(a.transpose(1, 2).to(f32) for a in (q, k, v)),
                           causal=True).transpose(1, 2)
    assert (got.to(f32) - causal).abs().max() > 0.1     # not the causal one


def test_moe_combine_k8_bitwise_run_to_run_and_cpu(dev):
    """moe_block at E = 16, k = 8 in bf16 on the card: two runs bitwise
    equal, and the combine bitwise the CPU's on the same contributions."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import dense_init
    mcfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").moe,
                               num_experts=16, top_k=8)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.init_moe(gen, 256, dataclasses.replace(mcfg, d_ff_expert=128),
                     torch.bfloat16, device=dev)
    x = dense_init(gen, (512, 256), scale=1.0, dtype=torch.bfloat16,
                   device=dev)
    mc = dataclasses.replace(mcfg, d_ff_expert=128)
    a, _ = moe.moe_block(p, x, mc)
    b, _ = moe.moe_block(p, x, mc)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    contrib = torch.randn((512 * 8, 256), generator=gen,
                          device=dev).to(torch.bfloat16)
    idx = torch.stack([torch.randperm(16, generator=gen, device=dev)[:8]
                       for _ in range(512)]).to(torch.int32)
    order = torch.argsort(idx.reshape(-1).long(), stable=True)
    got = moe.combine_ascending(contrib, order, idx)
    want = moe.combine_ascending(contrib.cpu(), order.cpu(), idx.cpu())
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


def test_zamba2_chunk_of_128_stays_finite(dev):
    """zamba2 at reduced() with its full config's chunk of 128, a 128-token
    prefill on the card: finite, and the last logits within 1e-3 of the
    token-by-token rebuild (float32)."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    cfg = get_config("zamba2-1.2b").reduced()
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk_size=128))
    params = R.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                         device=dev, dtype=torch.int32)
    before = common.LAUNCHES["flash_attention"]
    pl, _ = R.prefill(params, cfg, {"tokens": toks},
                      R.init_serve_state(cfg, 2, 128, device=dev))
    assert common.LAUNCHES["flash_attention"] == before + 1   # one site
    assert torch.isfinite(pl).all()
    state = R.init_serve_state(cfg, 2, 128, device=dev)
    for i in range(128):
        sl, state = R.serve_step(params, cfg, toks[:, i:i + 1], state)
    torch.testing.assert_close(pl, sl, rtol=1e-3, atol=1e-3)
