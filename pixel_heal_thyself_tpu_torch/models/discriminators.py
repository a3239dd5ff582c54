"""Discriminators (PyTorch, NHWC).

Port of `pixel_heal_thyself_tpu/models/discriminators.py`:
- `DiscriminatorVGG` (reference `pht/models/afgsa/model.py:264-344`), the
  prod critic: a 3×3 ConvBlock, then log2(input/4) stages of a 3×3 s1
  ConvBlock and a 4×4 s2 ConvBlock with BatchNorm and LeakyReLU, then
  Dense(flat→100) → LeakyReLU → Dense(100→1), output in float32;
- `DiscriminatorVGG128` (reference `model.py:128-261`), the fixed-128
  VGG-D classifier;
- `PatchGANDiscriminator` (reference `pht/models/mamba/model.py:241-293`),
  a BatchNorm 70×70 PatchGAN;
- `SNConv`, `PatchDiscriminator` and `MultiScaleDiscriminator` (reference
  `pht/models/afgsa/discriminators.py:8-63`): spectral-norm PatchGANs over
  x, x/2 and x/4, returning a list of three NHWC float32 logit maps.

The flattens run in NHWC order, as flax's do, so the Dense kernels map by
a plain transpose (`params.py`). Convs and Dense layers compute in
`dtype`; BatchNorm normalises in float32.

Spectral norm keeps its power-iteration vector `u` as a registered
buffer (it lands in `state_dict` and in checkpoints) and writes it only
inside `spectral_norm_update(module)`, as the JAX `SNConv` writes its
`spectral` collection only when the caller makes it mutable: the train
step writes it in the D step's fake forward alone.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from pixel_heal_thyself_tpu_torch.models.layers import ConvBlock, apply_act
from pixel_heal_thyself_tpu_torch.utils.init import (
    torch_default_bias_init_,
    torch_default_kernel_init_,
)


class Dense(nn.Module):
    """flax `nn.Dense` with torch-default init: weight [out, in] (torch
    Linear layout), bias [out]; computes in `dtype`."""

    def __init__(self, in_features: int, out_features: int, *, dtype: torch.dtype,
                 generator: torch.Generator | None) -> None:
        super().__init__()
        self.dtype = dtype
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _dense_head(x: torch.Tensor, dense0: Dense, dense1: Dense) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)  # NHWC order, as flax flattens
    x = apply_act(dense0(x), "leakyrelu")
    return dense1(x).float()


class DiscriminatorVGG(nn.Module):
    """Patch-size-parametric VGG-style critic: [B, S, S, in_nc] → [B, 1]
    float32 logits."""

    def __init__(
        self, in_nc: int = 3, base_nf: int = 64, input_size: int = 128,
        norm_type: str = "batch", act_type: str = "leakyrelu",
        dtype: torch.dtype = torch.float32, device=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        g = generator
        blocks = [ConvBlock(in_nc, base_nf, 3, padding=1, act_type=act_type, dtype=dtype,
                            generator=g)]
        nf = base_nf
        num_downsample = int(math.log2(input_size / 4))
        for i in range(num_downsample):
            next_nf = min(base_nf * 2 ** (i + 1), base_nf * 8)
            blocks.append(ConvBlock(nf, next_nf, 3, stride=1, padding=1, norm_type=norm_type,
                                    act_type=act_type, dtype=dtype, generator=g))
            blocks.append(ConvBlock(next_nf, next_nf, 4, stride=2, padding=1,
                                    norm_type=norm_type, act_type=act_type, dtype=dtype,
                                    generator=g))
            nf = next_nf
        self.blocks = nn.ModuleList(blocks)
        side = input_size // 2 ** num_downsample
        self.dense0 = Dense(nf * side * side, 100, dtype=dtype, generator=g)
        self.dense1 = Dense(100, 1, dtype=dtype, generator=g)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        return _dense_head(x, self.dense0, self.dense1)


class DiscriminatorVGG128(nn.Module):
    """Fixed-128-input VGG classifier: [B, 128, 128, in_nc] → [B, 1]
    float32 logits. Unlike `DiscriminatorVGG`, its first 4×4 s2 conv keeps
    base_nf and the deepest stage repeats base_nf·8 once more."""

    def __init__(
        self, in_nc: int = 3, base_nf: int = 64, norm_type: str = "batch",
        act_type: str = "leakyrelu", dtype: torch.dtype = torch.float32, device=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        g = generator
        blocks = [ConvBlock(in_nc, base_nf, 3, padding=1, act_type=act_type, dtype=dtype,
                            generator=g)]
        # (4×4 s2 same-ch, 3×3 s1 next-ch) pairs — reference conv1..conv9
        stage_nf = [base_nf, base_nf * 2, base_nf * 2, base_nf * 4, base_nf * 4,
                    base_nf * 8, base_nf * 8, base_nf * 8, base_nf * 8]
        nf = base_nf
        for i, next_nf in enumerate(stage_nf):
            k, stride = (4, 2) if i % 2 == 0 else (3, 1)
            blocks.append(ConvBlock(nf, next_nf, k, stride=stride, padding=1,
                                    norm_type=norm_type, act_type=act_type, dtype=dtype,
                                    generator=g))
            nf = next_nf
        self.blocks = nn.ModuleList(blocks)
        # five stride-2 convs take the 128² input to 4²
        self.dense0 = Dense(nf * 4 * 4, 100, dtype=dtype, generator=g)
        self.dense1 = Dense(100, 1, dtype=dtype, generator=g)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        return _dense_head(x, self.dense0, self.dense1)


class PatchGANDiscriminator(nn.Module):
    """Plain BatchNorm PatchGAN: 4×4 convs at strides 2, 2, 2, 1 (base_nf →
    ·2 → ·4 → ·8, BatchNorm on all but the first, LeakyReLU) then an
    unnormed 1-channel 4×4 s1 head; NHWC float32 logit map out."""

    def __init__(self, in_nc: int = 3, base_nf: int = 64, dtype: torch.dtype = torch.float32,
                 device=None, generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        conv = dict(padding=1, dtype=dtype, generator=generator)
        blocks = [ConvBlock(in_nc, base_nf, 4, stride=2, act_type="leakyrelu", **conv)]
        nf = base_nf
        for next_nf, stride in ((base_nf * 2, 2), (base_nf * 4, 2), (base_nf * 8, 1)):
            blocks.append(ConvBlock(nf, next_nf, 4, stride=stride, norm_type="batch",
                                    act_type="leakyrelu", **conv))
            nf = next_nf
        blocks.append(ConvBlock(nf, 1, 4, act_type=None, **conv))
        self.blocks = nn.ModuleList(blocks)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        return x.float()


def _normalize(a: torch.Tensor, eps: float) -> torch.Tensor:
    return a / torch.clamp(torch.linalg.vector_norm(a), min=eps)


class SNConv(nn.Module):
    """Conv2d under spectral normalisation (torch `spectral_norm`, one
    power iteration a call): weight [out, in, k, k] and bias, both float32;
    the buffer `u` [out]. A forward computes, from the stored u and the
    weight as a matrix [out, in·k·k], v = normalize(Wᵀu) and u_new =
    normalize(W v), both without gradient, and σ = u_newᵀ W v, whose
    gradient runs through W; it convolves (zero padding, `stride`) with
    (W / σ) in `dtype`. It writes u_new into `u` only while
    `update_u` is set (`spectral_norm_update`)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 4, stride: int = 2,
                 padding: int = 1, eps: float = 1e-12, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.stride, self.padding, self.eps, self.dtype = stride, padding, eps, dtype
        self.update_u = False
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_ch, k, k))
        self.bias = nn.Parameter(torch.empty(features))
        torch_default_kernel_init_(self.weight, generator)
        torch_default_bias_init_(self.bias, k * k * in_ch, generator)
        # the JAX init draws u from PRNGKey(0), which torch cannot
        # reproduce: the port draws it from `generator`
        u = torch.empty(features).normal_(generator=generator)
        self.register_buffer("u", _normalize(u, eps))

    def sigma(self, write: bool = False) -> torch.Tensor:
        """σ of the current weight from the stored `u` (one power
        iteration); with `write`, u_new is stored."""
        w = self.weight.reshape(self.weight.shape[0], -1)
        with torch.no_grad():
            v = _normalize(w.t() @ self.u, self.eps)
            u_new = _normalize(w @ v, self.eps)
        if write:
            with torch.no_grad():
                self.u.copy_(u_new)
        return u_new @ (w @ v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_hat = (self.weight / self.sigma(write=self.update_u)).to(self.dtype)
        p = self.padding
        y = F.conv2d(F.pad(x.to(self.dtype).permute(0, 3, 1, 2), (p, p, p, p)), w_hat,
                     stride=self.stride)
        return y.permute(0, 2, 3, 1) + self.bias.to(self.dtype)


@contextlib.contextmanager
def spectral_norm_update(module: nn.Module):
    """Within the block, every `SNConv` in `module` writes its power
    iteration's u_new into its `u` (the JAX `mutable=["spectral"]`).
    A module without one is unaffected."""
    convs = [m for m in module.modules() if isinstance(m, SNConv)]
    for m in convs:
        m.update_u = True
    try:
        yield
    finally:
        for m in convs:
            m.update_u = False


class PatchDiscriminator(nn.Module):
    """Spectral-norm PatchGAN whose depth keeps the last map ≥ `min_feat`:
    4×4 s2 SNConvs with LeakyReLU (base_nf, doubling up to base_nf·8) while
    the side halves to ≥ min_feat, then a 1-channel 4×4 s1 SNConv; NHWC
    float32 logit map out."""

    def __init__(self, in_nc: int = 3, base_nf: int = 64, input_size: int = 128,
                 min_feat: int = 4, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        convs = []
        nf_in, nf_out, size = in_nc, base_nf, input_size
        while size // 2 >= min_feat:
            convs.append(SNConv(nf_in, nf_out, 4, 2, 1, dtype=dtype, generator=generator))
            nf_in, nf_out = nf_out, min(nf_out * 2, base_nf * 8)
            size //= 2
        convs.append(SNConv(nf_in, 1, 4, 1, 1, dtype=dtype, generator=generator))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs[:-1]:
            x = apply_act(conv(x), "leakyrelu")
        return self.convs[-1](x).float()


class MultiScaleDiscriminator(nn.Module):
    """Three `PatchDiscriminator`s over x, x average-pooled 2×2 and x
    average-pooled 4×4 (both from x): a list of three NHWC float32 logit
    maps."""

    def __init__(self, in_nc: int = 3, patch_size: int = 128,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.d1, self.d2, self.d3 = (
            PatchDiscriminator(in_nc, input_size=patch_size // s, dtype=dtype,
                               generator=generator)
            for s in (1, 2, 4)
        )
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = x.to(self.dtype)
        x_nchw = x.permute(0, 3, 1, 2)
        x2 = F.avg_pool2d(x_nchw, 2).permute(0, 2, 3, 1)
        x4 = F.avg_pool2d(x_nchw, 4).permute(0, 2, 3, 1)
        return [self.d1(x), self.d2(x2), self.d3(x4)]
