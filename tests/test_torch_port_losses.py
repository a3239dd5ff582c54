"""PyTorch port: losses and batch preparation against the JAX package.

`l1_loss`, `gan_loss` in its four modes and `prepare_batch` on the same
numpy inputs in float32 (elementwise maps and means: 1e-6 relative).
`gradient_penalty` against the JAX one with the same interpolation draw —
the uniform alpha comes from `jax.random`, as tests/test_reference_parity.py
:350-353 draws it, and is handed to the port — through the same
DiscriminatorVGG weights (a BatchNorm critic, so the batch coupling of the
summed-output gradient is exercised), at HIGHEST precision: 1e-4 relative
(a double backward through seven float32 convs), and its gradient w.r.t.
the critic's parameters exists (the penalty is differentiable).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu import losses as jlosses  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    DiscriminatorVGG as JDiscriminatorVGG,
)
from pixel_heal_thyself_tpu.ops.transforms import prepare_batch as jprepare  # noqa: E402
from pixel_heal_thyself_tpu_torch import losses  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.transforms import prepare_batch  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import discriminator_state_from_flax  # noqa: E402


def _close(got, want, rel=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def test_l1_loss_matches_jax():
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal((2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    _close(losses.l1_loss(torch.from_numpy(x), torch.from_numpy(y)),
           jlosses.l1_loss(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("mode", ["wgan", "nsgan", "lsgan", "hinge"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("is_d", [True, False])
def test_gan_loss_matches_jax(mode, real, is_d):
    pred = np.random.default_rng(1).standard_normal((6, 1)).astype(np.float32) * 2
    _close(losses.gan_loss(torch.from_numpy(pred), real, mode, is_d),
           jlosses.gan_loss(jnp.asarray(pred), real, mode, is_d))


def test_gan_loss_rejects_unknown_mode():
    with pytest.raises(NotImplementedError):
        losses.gan_loss(torch.zeros(2, 1), True, "wasserstein")


@pytest.mark.parametrize("log_gt", [True, False])
def test_prepare_batch_matches_jax(log_gt):
    rng = np.random.default_rng(2)
    noisy = np.abs(rng.standard_normal((2, 8, 8, 3))).astype(np.float32)
    gt = np.abs(rng.standard_normal((2, 8, 8, 3))).astype(np.float32)
    aux = rng.uniform(-1.5, 1.5, (2, 8, 8, 7)).astype(np.float32)
    got = prepare_batch(*map(torch.from_numpy, (noisy, gt, aux)), log_gt=log_gt)
    want = jprepare(*map(jnp.asarray, (noisy, gt, aux)), log_gt=log_gt)
    for g, w in zip(got, want):
        _close(g, w)


def test_gradient_penalty_matches_jax():
    rng = np.random.default_rng(3)
    real = np.abs(rng.standard_normal((2, 16, 16, 3))).astype(np.float32)
    fake = np.abs(rng.standard_normal((2, 16, 16, 3))).astype(np.float32)
    jd = JDiscriminatorVGG(input_size=16, base_nf=8)
    params = jax.tree.map(np.asarray, jax.jit(jd.init)(jax.random.PRNGKey(0),
                                                       jnp.asarray(real))["params"])
    key = jax.random.fold_in(jax.random.PRNGKey(7), jnp.int32(0))
    alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32))

    gp = jax.jit(lambda r, f, k: jlosses.gradient_penalty(
        lambda x: jd.apply({"params": params}, x), r, f, k))
    with jax.default_matmul_precision("highest"):
        want = gp(jnp.asarray(real), jnp.asarray(fake), key)
    d = DiscriminatorVGG(input_size=16, base_nf=8)
    d.load_state_dict(discriminator_state_from_flax(params))
    got = losses.gradient_penalty(d, torch.from_numpy(real), torch.from_numpy(fake),
                                  alpha=torch.from_numpy(alpha.copy()))
    _close(got, want, 1e-4)
    # the last dense bias does not move the input gradient: unused
    grads = [g for g in torch.autograd.grad(got, list(d.parameters()), allow_unused=True)
             if g is not None]
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(g.abs().sum() > 0 for g in grads)


def test_gradient_penalty_draws_alpha_from_generator():
    d = DiscriminatorVGG(input_size=8, base_nf=4, generator=torch.Generator().manual_seed(0))
    real, fake = torch.rand(2, 8, 8, 3), torch.rand(2, 8, 8, 3)
    a = losses.gradient_penalty(d, real, fake, generator=torch.Generator().manual_seed(5))
    b = losses.gradient_penalty(d, real, fake, generator=torch.Generator().manual_seed(5))
    alpha = torch.rand((2, 1, 1, 1), generator=torch.Generator().manual_seed(5))
    c = losses.gradient_penalty(d, real, fake, alpha=alpha)
    assert torch.equal(a, b) and torch.equal(a, c)
