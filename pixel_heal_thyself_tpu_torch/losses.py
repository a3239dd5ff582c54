"""GAN and reconstruction losses of the prod step (PyTorch).

Port of `pixel_heal_thyself_tpu/losses.py`: `l1_loss`, `gan_loss` in its
four modes (wgan = ±mean of the critic output) and `gradient_penalty`
(WGAN-GP: the gradient of the *sum* of the critic outputs w.r.t. a
per-sample interpolation of real and detached fake, taken with
`create_graph=True` so the discriminator loss differentiates through it;
per-sample L2 norm in float32; mean((‖g‖ − 1)²)). `ra_hinge_gan_loss`,
`ssim_loss` and the other extras wait with the multiscale discriminator
(ROADMAP.md slice 7).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


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


def gradient_penalty(
    d_apply: Callable[[torch.Tensor], torch.Tensor],
    real_data: torch.Tensor,
    fake_data: torch.Tensor,
    alpha: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """WGAN-GP. `alpha` [B, 1, 1, 1] float32 interpolation weights, or drawn
    uniform from `generator` on the data's device when None."""
    shape = (real_data.shape[0],) + (1,) * (real_data.dim() - 1)
    if alpha is None:
        alpha = torch.rand(shape, generator=generator, device=real_data.device)
    alpha = alpha.to(device=real_data.device, dtype=torch.float32).reshape(shape)
    interp = alpha * fake_data.detach() + (1 - alpha) * real_data
    interp = interp.detach().requires_grad_(True)
    critic_sum = d_apply(interp).float().sum()
    (grads,) = torch.autograd.grad(critic_sum, interp, create_graph=True)
    norm = grads.reshape(grads.shape[0], -1).float().norm(dim=1)
    return torch.mean((norm - 1.0) ** 2)
