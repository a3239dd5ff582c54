"""PyTorch-default parameter initializers drawing from a passed generator.

Port of `pixel_heal_thyself_tpu/utils/init.py`. Weights are OIHW here
(`[out, in, kh, kw]`, torch's conv layout), so fan_in = in·kh·kw and
fan_out = out·kh·kw — the same fans the JAX package reads off its HWIO
kernels. Every initializer fills its tensor in place from `generator`,
so a model built twice from equally seeded generators is identical.
"""

from __future__ import annotations

import math

import torch


def _fans(shape: tuple[int, ...]) -> tuple[int, int]:
    """(fan_in, fan_out) of an OIHW conv kernel."""
    if len(shape) != 4:
        raise ValueError(f"expected an OIHW conv kernel, got shape {shape}")
    rf = shape[2] * shape[3]
    return shape[1] * rf, shape[0] * rf


@torch.no_grad()
def torch_default_kernel_init_(w: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """torch Conv2d/Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    fan_in, _ = _fans(tuple(w.shape))
    bound = 1.0 / math.sqrt(fan_in)
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def torch_default_bias_init_(
    b: torch.Tensor, fan_in: int, generator: torch.Generator | None,
) -> torch.Tensor:
    """torch Conv2d/Linear default bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return b.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def kaiming_normal_fan_out_(w: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """kaiming_normal_(mode='fan_out', nonlinearity='relu'): N(0, 2/fan_out)."""
    _, fan_out = _fans(tuple(w.shape))
    return w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


@torch.no_grad()
def normal_unit_(w: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """N(0, 1) — the rel_h/rel_w init."""
    return w.normal_(0.0, 1.0, generator=generator)
