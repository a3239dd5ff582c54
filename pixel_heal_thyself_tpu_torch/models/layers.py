"""Shared building blocks: conv, conv block, activation.

Port of `pixel_heal_thyself_tpu/models/layers.py` (`Conv`, `ConvBlock`,
`apply_act`). NHWC at every public function, explicit torch-parity
padding, torch-default initializers from a passed generator. Weights are
stored OIHW (`[out, in, kh, kw]`) in float32; compute runs in `dtype`.
BatchNorm, InstanceNorm and PReLU serve only the discriminators and are
not ported yet (ROADMAP.md slice 2, the training step).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pixel_heal_thyself_tpu_torch.ops.padding import pad2d
from pixel_heal_thyself_tpu_torch.utils.init import (
    torch_default_bias_init_,
    torch_default_kernel_init_,
)


def apply_act(x: torch.Tensor, act_type: str | None, neg_slope: float = 0.2) -> torch.Tensor:
    if act_type is None:
        return x
    act_type = act_type.lower()
    if act_type == "relu":
        return F.relu(x)
    if act_type == "leakyrelu":
        return F.leaky_relu(x, negative_slope=neg_slope)
    raise NotImplementedError(f"Activation layer [{act_type}] is not found")


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """VALID stride-1 convolution of NHWC `x` with an OIHW `weight` in
    `dtype`. A 1×1 kernel runs as a matmul over the pixels, as the JAX
    `Conv` does."""
    w = weight.to(dtype)
    x = x.to(dtype)
    if w.shape[2:] == (1, 1):
        return x @ w[:, :, 0, 0].t()
    y = F.conv2d(x.permute(0, 3, 1, 2), w)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """Conv weight [out, in, k, k] (+ bias [out]) applied to NHWC input
    that the caller has already padded."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel_size: int, *, use_bias: bool = True,
        dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        torch_default_kernel_init_(self.weight, generator)
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_ch))
            torch_default_bias_init_(self.bias, k * k * in_ch, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_nhwc(x, self.weight, self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class ConvBlock(nn.Module):
    """pad2d → conv (+ bias) → optional activation (reference conv_block
    without normalization, which only the discriminators use)."""

    def __init__(
        self, in_ch: int, features: int, kernel_size: int, *, padding: int = 0,
        padding_mode: str = "zeros", act_type: str | None = "relu",
        use_bias: bool = True, dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.padding = padding
        self.padding_mode = padding_mode
        self.act_type = act_type
        self.conv = Conv(
            in_ch, features, kernel_size, use_bias=use_bias, dtype=dtype,
            generator=generator,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad2d(x, self.padding, self.padding_mode)
        return apply_act(self.conv(x), self.act_type)
