"""The port's training loss and its gradients against the reference's, on
the CPU: ``registry.train_loss`` for every arch id at ``reduced()``
(float32, 2 layers, batch 2 x 32 tokens, weights (1, 0): a dropped
cohort), from the reference's own parameters (``lm_params_from_jax``),
against ``jax.jit(jax.value_and_grad(repro.models.registry.train_loss))``.

On the CPU every kernel of the path takes its plain version, so autograd
differentiates the same functions as XLA; what differs is the order of
float32 sums. Tolerances, per arch type (losses ~6.2-6.9, gradients up
to ~0.5): the loss within ``LOSS_TOL`` relative; each gradient leaf
within ``GRAD_TOL[type]`` of the leaf's largest reference value (max
|got - want| / max(max |want|, 1e-6)). Measured worst leaves: dense 2.7e-6
(qwen2.5-14b's ``bk``), moe 3.4e-6 (expert ``w_gate``; the routing is
equal: equal logits pick equal experts and drop equal assignments), vlm
2.0e-6, audio 2.3e-6; ssm 1.4e-5 (``u``: the per-step WKV recurrence
against the reference's chunked form, which sums over whole chunks);
hybrid 4.4e-6 (``a_log``: the SSD form as differences of cumulative
sums against the reference's scaled form, R12). Each bound is about
five times the measured value or more.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import np_, one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, S = 2, 32
LOSS_TOL = 1e-6
GRAD_TOL = {"dense": 2e-5, "moe": 2e-5, "vlm": 2e-5, "audio": 2e-5,
            "ssm": 1e-4, "hybrid": 3e-5}


def batch_for(cfg, seed=0):
    """tokens, labels (B, S) int32 and, for audio and vlm, embeddings
    (B, n, d) float32, from numpy."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    n = {"audio": ("frames", cfg.num_frames),
         "vlm": ("patches", cfg.num_patches)}.get(cfg.arch_type)
    if n:
        out[n[0]] = rng.standard_normal((B, n[1], cfg.d_model)).astype(
            np.float32)
    return out


def reference(cfg, params, batch, weights):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b, w: JR.train_loss(p, cfg, b, weights=w)))
    loss, grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                     jnp.asarray(weights))
    return float(loss), jax.tree.map(np.asarray, grads)


def port(cfg, params, batch, weights, remat=False):
    from repro_torch.fed.distributed import value_and_grad
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    return value_and_grad(cfg, params, tb, torch.as_tensor(weights),
                          remat=remat)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def grad_errors(got, want):
    """Each leaf's max |got - want| over max(max |want|, 1e-6)."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    return {k: float(np.abs(np_(g[k]) - w[k]).max()
                     / max(float(np.abs(w[k]).max()), 1e-6)) for k in w}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_grads_match_the_reference(arch):
    jc, tc = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = jax.tree.map(np.asarray, JR.init_params(jc, jax.random.PRNGKey(1)))
    batch = batch_for(tc)
    weights = np.array([1.0, 0.0], np.float32)
    want_loss, want_g = reference(jc, jp, batch, weights)
    loss, grads = port(tc, lm_params_from_jax(jp, "cpu"), batch, weights)
    assert abs(float(loss) - want_loss) <= LOSS_TOL * max(1.0, abs(want_loss))
    errs = grad_errors(grads, want_g)
    worst = max(errs, key=errs.get)
    print(f"{arch}: loss {float(loss):.6f} (ref {want_loss:.6f}), worst "
          f"grad {worst} {errs[worst]:.2e}")
    assert errs[worst] <= GRAD_TOL[tc.arch_type], (worst, errs[worst])
