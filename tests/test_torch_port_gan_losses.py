"""PyTorch port: the multiscale step's losses, MS-SSIM and LPIPS against JAX.

Same seeded numpy inputs through the JAX function and the port's, float32
on the CPU, JAX at HIGHEST precision; each value and each input gradient
is compared relative to the reference's largest magnitude:
- elementwise maps and means (`ra_hinge_gan_loss`, `tone_mapping_loss`,
  `bce_loss`, `bce_loss_logits`, `to_lpips_range`): 1e-6 values, 1e-5
  gradients;
- `wdiv_gradient_penalty` through the same DiscriminatorVGG weights and
  interpolation draw: 1e-4 (a double backward through seven convs);
- `ms_ssim`, `ms_ssim_loss`, `ms_ssim_mix_loss` and `ssim_loss` at 32²:
  1e-5 values, 1e-4 gradients. The port filters with two 1-D passes of
  the Gaussian whose outer product is the JAX 2-D window, so its sums
  differ in float32 rounding only;
- LPIPS: `random_lpips_params` gives the JAX arrays bit for bit (HWIO →
  OIHW), `load_lpips_params` reads an npz in `tools/convert_lpips_weights.py`'s
  layout (random contents) into the same arrays as the JAX loader, and
  `lpips_distance` at 32², batch 2, through `to_lpips_range`: 1e-4 values,
  1e-3 gradients (thirteen float32 convs and the unit normalisations).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu import losses as jlosses  # noqa: E402
from pixel_heal_thyself_tpu.models import lpips as jlpips  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    DiscriminatorVGG as JDiscriminatorVGG,
)
from pixel_heal_thyself_tpu.ops import msssim as jmsssim  # noqa: E402
from pixel_heal_thyself_tpu_torch import losses  # noqa: E402
from pixel_heal_thyself_tpu_torch.models import lpips  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import msssim  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import (  # noqa: E402
    discriminator_state_from_flax,
    lpips_params_from_jax,
)


def _close(got, want, rel, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _value_and_grads(jfn, tfn, arrays, rel_v, rel_g):
    """`jfn` and `tfn` (scalar losses) on the same arrays: the value and
    the gradient w.r.t. every array."""
    with jax.default_matmul_precision("highest"):
        want, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(len(arrays)))))(
            *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = tfn(*ts)
    _close(got, want, rel_v, "value")
    got.backward()
    for i, (t, g) in enumerate(zip(ts, jgrads)):
        _close(t.grad, g, rel_g, f"grad {i}")


def _images(seed, b=2, s=32, lo=0.0, hi=1.5):
    """A target and an output near it (SSIM's use: uncorrelated noise puts
    every contrast-structure term near 0, where float32 cancellation in
    E[xy] − μxμy dominates either framework's value)."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(lo, hi, (b, s, s, 3)).astype(np.float32)
    x = np.clip(y + rng.normal(0, 0.1 * (hi - lo), y.shape), lo, hi).astype(np.float32)
    return [x, y]


def test_ra_hinge_gan_loss_matches_jax():
    rng = np.random.default_rng(0)
    shapes = [(2, 3, 3, 1), (2, 2, 2, 1), (2, 5, 5, 2)]
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes * 2]

    def jfn(*a):
        return jlosses.ra_hinge_gan_loss(a[:3], a[3:])

    def tfn(*a):
        return losses.ra_hinge_gan_loss(a[:3], a[3:])

    _value_and_grads(jfn, tfn, arrays, 1e-6, 1e-5)


@pytest.mark.parametrize("name", ["tone_mapping_loss", "bce_loss", "bce_loss_logits"])
def test_elementwise_losses_match_jax(name):
    rng = np.random.default_rng(1)
    if name == "bce_loss":
        x = rng.uniform(0.01, 0.99, (2, 8, 8, 3)).astype(np.float32)
        t = rng.uniform(0, 1, x.shape).astype(np.float32)
    else:
        x = (rng.standard_normal((2, 8, 8, 3)) * (1 if name == "bce_loss_logits" else 0.4)
             + (0 if name == "bce_loss_logits" else 1)).astype(np.float32)
        t = np.abs(rng.standard_normal(x.shape)).astype(np.float32)
    _value_and_grads(getattr(jlosses, name), getattr(losses, name), [x, t], 1e-6, 1e-5)


def test_wdiv_gradient_penalty_matches_jax():
    rng = np.random.default_rng(3)
    real = np.abs(rng.standard_normal((2, 16, 16, 3))).astype(np.float32)
    fake = np.abs(rng.standard_normal((2, 16, 16, 3))).astype(np.float32)
    jd = JDiscriminatorVGG(input_size=16, base_nf=8)
    params = jax.tree.map(np.asarray, jax.jit(jd.init)(jax.random.PRNGKey(0),
                                                       jnp.asarray(real))["params"])
    key = jax.random.PRNGKey(11)
    alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32))
    wdiv = jax.jit(lambda r, f, k: jlosses.wdiv_gradient_penalty(
        lambda x: jd.apply({"params": params}, x), r, f, k))
    with jax.default_matmul_precision("highest"):
        want = wdiv(jnp.asarray(real), jnp.asarray(fake), key)
    d = DiscriminatorVGG(input_size=16, base_nf=8)
    d.load_state_dict(discriminator_state_from_flax(params))
    got = losses.wdiv_gradient_penalty(d, torch.from_numpy(real), torch.from_numpy(fake),
                                       alpha=torch.from_numpy(alpha.copy()))
    _close(got, want, 1e-4)
    grads = [g for g in torch.autograd.grad(got, list(d.parameters()), allow_unused=True)
             if g is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("size", [32, 64])
def test_ms_ssim_matches_jax(size):
    x, y = _images(4, s=size)
    want = jmsssim.ms_ssim(jnp.asarray(x), jnp.asarray(y), max_val=1.5)
    _close(msssim.ms_ssim(torch.from_numpy(x), torch.from_numpy(y), max_val=1.5), want, 1e-5)
    _value_and_grads(jmsssim.ms_ssim_loss, msssim.ms_ssim_loss, [x, y], 1e-5, 1e-4)


def test_ms_ssim_mix_loss_matches_jax():
    _value_and_grads(jmsssim.ms_ssim_mix_loss, msssim.ms_ssim_mix_loss, _images(5),
                     1e-5, 1e-4)


def test_ssim_loss_matches_jax():
    # log-radiance-like values, some pixels' channel max above 1 (the clamp)
    _value_and_grads(jlosses.ssim_loss, losses.ssim_loss, _images(6, lo=0.0, hi=2.5),
                     1e-5, 1e-4)


def test_random_lpips_params_are_the_jax_arrays():
    want = jlpips.random_lpips_params(3)
    got = lpips.random_lpips_params(3)
    assert len(got["convs"]) == 13 and len(got["lins"]) == 5
    for (w, b), (jw, jb) in zip(got["convs"], want["convs"]):
        assert np.array_equal(w.numpy(), np.transpose(np.asarray(jw), (3, 2, 0, 1)))
        assert np.array_equal(b.numpy(), np.asarray(jb))
    for lin, jlin in zip(got["lins"], want["lins"]):
        assert np.array_equal(lin.numpy(), np.asarray(jlin))
    bridged = lpips_params_from_jax(want)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(bridged["convs"], got["convs"]))


def test_load_lpips_params_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    raw, in_ch = {}, 3
    for idx, out_ch in jlpips._VGG16_CONVS:
        raw[f"features.{idx}.weight"] = rng.standard_normal((out_ch, in_ch, 3, 3)).astype(
            np.float32)
        raw[f"features.{idx}.bias"] = rng.standard_normal(out_ch).astype(np.float32)
        in_ch = out_ch
    for k, c in enumerate(jlpips._TAP_CHANNELS):
        raw[f"lin{k}.weight"] = rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32)
    path = tmp_path / "lpips_vgg.npz"
    np.savez(path, **raw)
    got = lpips.load_lpips_params(path)
    want = lpips_params_from_jax(jlpips.load_lpips_params(path))
    for (w, b), (jw, jb) in zip(got["convs"], want["convs"]):
        assert torch.equal(w, jw) and torch.equal(b, jb)
    assert all(torch.equal(a, b) for a, b in zip(got["lins"], want["lins"]))
    assert torch.equal(got["convs"][0][0], torch.from_numpy(raw["features.0.weight"]))


def test_to_lpips_range_matches_jax():
    x = np.random.default_rng(9).uniform(-0.5, 2.0, (2, 8, 8, 3)).astype(np.float32)
    x[1] *= 0.25  # the second sample well below the batch max
    _value_and_grads(lambda a: jnp.sum(jnp.sin(3 * jlpips.to_lpips_range(a))),
                     lambda a: torch.sum(torch.sin(3 * lpips.to_lpips_range(a))), [x],
                     1e-6, 1e-5)


def test_lpips_distance_matches_jax():
    jparams = jlpips.random_lpips_params(0)
    params = lpips.random_lpips_params(0)
    x, y = _images(10, lo=0.0, hi=1.5)

    def jfn(a, b):
        d = jlpips.lpips_distance(jparams, jlpips.to_lpips_range(a), jlpips.to_lpips_range(b))
        return jnp.mean(d), d

    with jax.default_matmul_precision("highest"):
        (_, want), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
            jnp.asarray(x), jnp.asarray(y))
    xt, yt = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
    got = lpips.lpips_distance(params, lpips.to_lpips_range(xt), lpips.to_lpips_range(yt))
    assert got.shape == (2,)
    _close(got, want, 1e-4, "distance")
    got.mean().backward()
    _close(xt.grad, jgrads[0], 1e-3, "dx")
    _close(yt.grad, jgrads[1], 1e-3, "dy")
