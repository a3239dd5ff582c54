"""Discriminators (PyTorch, NHWC): the VGG-style critic of the prod step.

Port of `pixel_heal_thyself_tpu/models/discriminators.py:45-103`
(`DiscriminatorVGG`, reference `pht/models/afgsa/model.py:264-344`): a
3×3 ConvBlock, then log2(input/4) stages of a 3×3 s1 ConvBlock and a 4×4
s2 ConvBlock with BatchNorm and LeakyReLU, then Dense(flat→100) →
LeakyReLU → Dense(100→1), output in float32. The flatten runs in NHWC
order, as flax's does, so the Dense kernels map by a plain transpose
(`params.discriminator_state_from_flax`). Convs and Dense layers compute
in `dtype`; BatchNorm normalises in float32.

The other discriminators (`DiscriminatorVGG128`, `PatchDiscriminator`,
`MultiScaleDiscriminator`, `PatchGANDiscriminator`) wait for ROADMAP.md
slice 7.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pixel_heal_thyself_tpu_torch.models.layers import ConvBlock, apply_act


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
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax flattens
        x = apply_act(self.dense0(x), "leakyrelu")
        return self.dense1(x).float()
