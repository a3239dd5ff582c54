"""Shared building blocks: conv, norms, activations, conv block.

Port of `pixel_heal_thyself_tpu/models/layers.py` (`Conv`, `BatchNorm2d`,
`InstanceNorm2d`, `apply_act`, `PReLU`, `ConvBlock`). NHWC at every public
function, explicit torch-parity padding, torch-default initializers from a
passed generator. Weights are stored OIHW (`[out, in, kh, kw]`) in
float32; compute runs in `dtype`. The norms use batch (or instance)
statistics only and normalise in float32, as the JAX package does: the
reference never consumes running averages, so none are kept.
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


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype,
              stride: int = 1) -> torch.Tensor:
    """VALID convolution of NHWC `x` with an OIHW `weight` in `dtype`. A
    1×1 stride-1 kernel runs as a matmul over the pixels, as the JAX
    `Conv` does."""
    w = weight.to(dtype)
    x = x.to(dtype)
    if w.shape[2:] == (1, 1) and stride == 1:
        return x @ w[:, :, 0, 0].t()
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """Conv weight [out, in, k, k] (+ bias [out]) applied to NHWC input
    that the caller has already padded."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel_size: int, *, stride: int = 1,
        use_bias: bool = True, dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        torch_default_kernel_init_(self.weight, generator)
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_ch))
            torch_default_bias_init_(self.bias, k * k * in_ch, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_nhwc(x, self.weight, self.dtype, self.stride)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class BatchNorm2d(nn.Module):
    """Batch-statistics normalization with affine params (torch train
    mode): f32 mean and biased variance over N, H, W; `scale`/`bias` as
    the flax names."""

    def __init__(self, ch: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(0, 1, 2))
        var = xf.var(dim=(0, 1, 2), unbiased=False)
        y = (xf - mean) / torch.sqrt(var + self.eps)
        return (y * self.scale + self.bias).to(self.dtype)


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel spatial normalization (affine=False)."""

    def __init__(self, eps: float = 1e-5, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = xf.var(dim=(1, 2), keepdim=True, unbiased=False)
        return ((xf - mean) / torch.sqrt(var + self.eps)).to(self.dtype)


class PReLU(nn.Module):
    """Parametric ReLU with a single learnable slope (torch nn.PReLU)."""

    def __init__(self, init_slope: float = 0.2) -> None:
        super().__init__()
        self.slope = nn.Parameter(torch.full((1,), init_slope))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.slope.to(x.dtype) * x)


class ConvBlock(nn.Module):
    """pad2d → conv (+ bias) → optional norm → optional activation
    (reference conv_block). `forward(x, pad_fn)` pads with `pad_fn(x, pad,
    mode)` in place of `pad2d`: the sequence-sharded Mamba path passes the
    row-halo exchange (`ops/padding.make_row_halo_pad`), so every rank's
    convolution sees its true neighbour rows."""

    def __init__(
        self, in_ch: int, features: int, kernel_size: int, *, stride: int = 1,
        padding: int = 0, padding_mode: str = "zeros", norm_type: str | None = None,
        act_type: str | None = "relu", use_bias: bool = True,
        dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.padding = padding
        self.padding_mode = padding_mode
        self.act_type = act_type
        self.conv = Conv(
            in_ch, features, kernel_size, stride=stride, use_bias=use_bias, dtype=dtype,
            generator=generator,
        )
        self.norm = None
        if norm_type:
            nt = norm_type.lower()
            if nt == "batch":
                self.norm = BatchNorm2d(features, dtype=dtype)
            elif nt == "instance":
                self.norm = InstanceNorm2d(dtype=dtype)
            else:
                raise NotImplementedError(f"Normalization layer [{nt}] is not found")
        self.prelu = PReLU() if act_type and act_type.lower() == "prelu" else None

    def forward(self, x: torch.Tensor, pad_fn=None) -> torch.Tensor:
        pad = pad2d if pad_fn is None else pad_fn
        x = self.conv(pad(x, self.padding, self.padding_mode))
        if self.norm is not None:
            x = self.norm(x)
        if self.prelu is not None:
            return self.prelu(x)
        return apply_act(x, self.act_type)
