"""GAN and reconstruction losses (PyTorch).

Port of `pixel_heal_thyself_tpu/losses.py`: `l1_loss`, `gan_loss` in its
four modes (wgan = ±mean of the critic output), `gradient_penalty`
(WGAN-GP: the gradient of the *sum* of the critic outputs w.r.t. a
per-sample interpolation of real and detached fake, taken with
`create_graph=True` so the discriminator loss differentiates through it;
per-sample L2 norm in float32; mean((‖g‖ − 1)²)) and
`wdiv_gradient_penalty` (the Wasserstein-divergence form),
`ra_hinge_gan_loss` (relativistic-average hinge over the multiscale
critic's lists of patch logits), `ssim_loss` (kornia's mixed MS-SSIM +
Gaussian-L1 on inputs divided by the target's per-pixel channel max,
clamped ≥ 1), `tone_mapping_loss` and the `bce_*` extras.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from pixel_heal_thyself_tpu_torch.ops.msssim import ms_ssim_mix_loss


def l1_loss(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x.float() - target.float()))


def gan_loss(pred: torch.Tensor, target_is_real: bool, loss_type: str = "wgan",
             is_discriminator: bool | None = None) -> torch.Tensor:
    """Single-logit GAN loss in the reference's four modes."""
    pred = pred.float()
    if loss_type == "wgan":
        return -pred.mean() if target_is_real else pred.mean()
    if loss_type == "nsgan":
        target = 1.0 if target_is_real else 0.0
        p = torch.sigmoid(pred)
        eps = 1e-12
        return -torch.mean(target * torch.log(p + eps) + (1 - target) * torch.log(1 - p + eps))
    if loss_type == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return torch.mean((pred - target) ** 2)
    if loss_type == "hinge":
        if is_discriminator:
            return F.relu(1.0 - pred).mean() if target_is_real else F.relu(1.0 + pred).mean()
        return (-pred).mean()
    raise NotImplementedError(f"GAN type {loss_type} is not found!")


def _interp_alpha(real_data, alpha, generator) -> torch.Tensor:
    """[B, 1, …] float32 interpolation weights: `alpha`, or drawn uniform
    from `generator` on the data's device when None."""
    shape = (real_data.shape[0],) + (1,) * (real_data.dim() - 1)
    if alpha is None:
        alpha = torch.rand(shape, generator=generator, device=real_data.device)
    return alpha.to(device=real_data.device, dtype=torch.float32).reshape(shape)


def _critic_input_grad(d_apply, interp: torch.Tensor) -> torch.Tensor:
    """∇ of the summed critic outputs w.r.t. `interp`, kept differentiable."""
    interp = interp.detach().requires_grad_(True)
    critic_sum = d_apply(interp).float().sum()
    (grads,) = torch.autograd.grad(critic_sum, interp, create_graph=True)
    return grads.reshape(grads.shape[0], -1)


def gradient_penalty(
    d_apply: Callable[[torch.Tensor], torch.Tensor],
    real_data: torch.Tensor,
    fake_data: torch.Tensor,
    alpha: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """WGAN-GP. `alpha` [B, 1, 1, 1] float32 interpolation weights, or drawn
    uniform from `generator` on the data's device when None."""
    alpha = _interp_alpha(real_data, alpha, generator)
    interp = alpha * fake_data.detach() + (1 - alpha) * real_data
    norm = _critic_input_grad(d_apply, interp).float().norm(dim=1)
    return torch.mean((norm - 1.0) ** 2)


def wdiv_gradient_penalty(
    d_apply: Callable[[torch.Tensor], torch.Tensor],
    real_data: torch.Tensor,
    fake_data: torch.Tensor,
    alpha: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    p: int = 6,
) -> torch.Tensor:
    """Wasserstein-divergence gradient penalty (reference :60-100):
    mean over samples of (Σ g²)^(p/2) at alpha·real + (1 − alpha)·fake,
    the fake detached."""
    alpha = _interp_alpha(real_data, alpha, generator)
    interp = alpha * real_data + (1 - alpha) * fake_data.detach()
    grads = _critic_input_grad(d_apply, interp)
    return torch.mean(torch.sum(grads**2, dim=1) ** (p / 2))


def ra_hinge_gan_loss(real_preds: Sequence[torch.Tensor],
                      fake_preds: Sequence[torch.Tensor]) -> torch.Tensor:
    """Relativistic-average hinge over lists of NHWC patch logits; the
    means run over N, H and W, per channel (reference: dims [0, 2, 3] of
    its NCHW maps)."""
    loss = 0.0
    for pr, pf in zip(real_preds, fake_preds):
        pr, pf = pr.float(), pf.float()
        real_mean = pr.mean(dim=(0, 1, 2), keepdim=True)
        fake_mean = pf.mean(dim=(0, 1, 2), keepdim=True)
        loss = loss + F.relu(1.0 - (pr - fake_mean)).mean()
        loss = loss + F.relu(1.0 + (pf - real_mean)).mean()
    return loss * 0.5


def ssim_loss(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Reference SSIMLoss (`losses.py:248-263`): `ms_ssim_mix_loss` on
    inputs divided by the target's per-pixel channel max, clamped ≥ 1."""
    scale = torch.maximum(target.amax(dim=-1, keepdim=True), target.new_tensor(1.0))
    return ms_ssim_mix_loss(x / scale, target / scale)


def tone_mapping_loss(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return l1_loss(x / (x + 1.0), target / (target + 1.0))


def bce_loss(pred_probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    eps = 1e-12
    p, t = pred_probs.float(), target.float()
    return -torch.mean(t * torch.log(p + eps) + (1 - t) * torch.log(1 - p + eps))


def bce_loss_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    logits, t = logits.float(), target.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * t
                      + torch.log1p(torch.exp(-logits.abs())))
