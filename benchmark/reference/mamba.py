"""Plain reference of the Mamba2 denoiser (MambaDenoiserNet), NHWC, float32.

The semantics of the program's generator, written out in plain PyTorch:
the multi-scale encoder of the noisy radiance and its 1×1 projection, a
2-D sinusoidal positional encoding, N MambaBlocks (LayerNorm → a Mamba2
layer over the raster-scanned pixels → residual → residual two-conv
feed-forward) and a 3-conv decoder whose last conv is LeakyReLU(0.2)'d,
with a global residual to the noisy input. The aux encoder's parameters
exist but no block reads them, as in the program (the reference quirk it
keeps).

The Mamba2 layer (Dao & Gu 2024, one group, scalar decay per head): in_proj
→ (z, xBC, dt); xBC through a causal depthwise conv1d (k = d_conv, tap 0
the oldest) and SiLU; dt = softplus(dt + dt_bias); A = −exp(A_log); the
SSD scan state_t = exp(dt_t·A)·state_{t−1} + dt_t·B_t ⊗ x_t, y_t = C_t ·
state_t + D·x_t, computed in its chunked matrix form (chunk 128); the gated
RMSNorm of y·silu(z) (eps 1e-5); out_proj.

Parameter names equal the program's, so one seeded state dict loads into
both.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nn import Arith, ConvBlock, MultiScaleEncoder, fan_in_bound, param


def ssd_chunked(x, dt, A, B, C, D, chunk: int, arith: Arith) -> torch.Tensor:
    """x [b, l, h, p], dt [b, l, h], A [h], B, C [b, l, n], D [h] → y [b, l, h, p]
    (l a multiple of `chunk`)."""
    b, l, h, p = x.shape
    n, q = B.shape[-1], chunk
    nc = l // q
    Bc, Cc = B.reshape(b, nc, q, n), C.reshape(b, nc, q, n)
    xdt = (x * dt[..., None]).reshape(b, nc, q, h, p)
    cum = torch.cumsum((dt * A).reshape(b, nc, q, h), dim=2)          # [b,nc,q,h]
    # each chunk's input to its final state, and its total decay
    S = arith.einsum("bcjn,bcjhp->bchnp", Bc, xdt * torch.exp(cum[:, :, -1:] - cum)[..., None])
    a = torch.exp(cum[:, :, -1])                                     # [b,nc,h]
    state = torch.zeros_like(S[:, 0])
    st_in = []
    for c in range(nc):
        st_in.append(state)
        state = a[:, c, :, None, None] * state + S[:, c]
    st_in = torch.stack(st_in, dim=1)                                # [b,nc,h,n,p]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    cumT = cum.permute(0, 1, 3, 2)                                   # [b,nc,h,q]
    decay = torch.exp((cumT[..., :, None] - cumT[..., None, :]).masked_fill(~causal, -math.inf))
    scores = arith.einsum("bcin,bcjn->bcij", Cc, Bc)
    y = arith.einsum("bchij,bcjhp->bcihp", scores[:, :, None] * decay, xdt)
    y = y + torch.exp(cum)[..., None] * arith.einsum("bcin,bchnp->bcihp", Cc, st_in)
    return y.reshape(b, l, h, p) + x * D[:, None]


class Mamba2Layer(nn.Module):
    chunk = 128

    def __init__(self, d_model: int, d_state: int, d_conv: int, expand: int, headdim: int):
        super().__init__()
        di = expand * d_model
        self.di, self.n, self.k, self.p, self.h = di, d_state, d_conv, headdim, di // headdim
        self.conv_dim = di + 2 * d_state
        self.in_proj = nn.Module()
        param(self.in_proj, "weight", (2 * di + 2 * d_state + self.h, d_model),
              fan_in_bound(d_model))
        param(self, "conv1d_weight", (d_conv, self.conv_dim), fan_in_bound(d_conv))
        param(self, "conv1d_bias", (self.conv_dim,), fan_in_bound(d_conv))
        param(self, "dt_bias", (self.h,), ("inv_softplus_log_uniform", 1e-3, 0.1, 1e-4))
        param(self, "A_log", (self.h,), ("log_uniform", 1.0, 16.0))
        param(self, "D", (self.h,), ("const", 1.0))
        self.norm = nn.Module()
        param(self.norm, "weight", (di,), ("const", 1.0))
        self.out_proj = nn.Module()
        param(self.out_proj, "weight", (d_model, di), fan_in_bound(di))

    def forward(self, u: torch.Tensor, arith: Arith) -> torch.Tensor:
        b, l, _ = u.shape
        di, n, h, p = self.di, self.n, self.h, self.p
        zxbcdt = arith.linear(u, self.in_proj.weight)
        z, xbc, dt = torch.split(zxbcdt, [di, self.conv_dim, h], dim=-1)
        xp = F.pad(xbc, (0, 0, self.k - 1, 0))
        conv = sum(self.conv1d_weight[t] * xp[:, t:t + l] for t in range(self.k))
        xbc = F.silu(conv + self.conv1d_bias)
        x, B, C = torch.split(xbc, [di, n, n], dim=-1)
        dt = F.softplus(dt + self.dt_bias)
        y = ssd_chunked(x.reshape(b, l, h, p), dt, -torch.exp(self.A_log), B, C, self.D,
                        self.chunk, arith).reshape(b, l, di)
        y = y * F.silu(z)
        y = y * torch.rsqrt(y.pow(2).mean(dim=-1, keepdim=True) + 1e-5) * self.norm.weight
        return arith.linear(y, self.out_proj.weight)


class LayerNorm(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        param(self, "scale", (d,), ("const", 1.0))
        param(self, "bias", (d,), ("const", 0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, 1e-5)


class MambaBlock(nn.Module):
    def __init__(self, ch: int, d_state: int, d_conv: int, expansion: int, headdim: int,
                 padding_mode: str) -> None:
        super().__init__()
        self.norm1 = LayerNorm(ch)
        self.mamba = Mamba2Layer(ch, d_state, d_conv, expansion, headdim)
        conv = dict(padding=1, padding_mode=padding_mode, act_type="relu")
        self.ffn1 = ConvBlock(ch, ch, 3, **conv)
        self.ffn2 = ConvBlock(ch, ch, 3, **conv)

    def forward(self, noisy, aux, arith: Arith):
        b, h, w, c = noisy.shape
        noisy = noisy + self.mamba(self.norm1(noisy.reshape(b, h * w, c)), arith).reshape(
            b, h, w, c)
        return noisy + self.ffn2(self.ffn1(noisy, arith), arith), aux


def positional_encoding_2d(channels: int, height: int, width: int) -> np.ndarray:
    """[H, W, C]: even channels sin(y·ω_k), odd channels cos(x·ω_k),
    ω_k = 10000^(−2k/C)."""
    pe = np.zeros((channels, height, width), np.float32)
    y_pos = np.repeat(np.arange(height)[:, None], width, axis=1)
    x_pos = np.repeat(np.arange(width)[None, :], height, axis=0)
    div = np.exp(np.arange(0, channels, 2) * -(math.log(10000.0) / channels))
    pe[0::2] = np.sin(y_pos[None] * div[:, None, None])
    pe[1::2] = np.cos(x_pos[None] * div[: channels // 2, None, None])
    return np.ascontiguousarray(pe.transpose(1, 2, 0))


class MambaDenoiserNet(nn.Module):
    def __init__(self, *, input_channels: int, aux_input_channels: int, base_ch: int,
                 enc_ch: int, num_blocks: int, d_state: int, d_conv: int, expansion: int,
                 headdim: int, padding_mode: str) -> None:
        super().__init__()
        self.base_ch = base_ch
        self.noisy_enc = MultiScaleEncoder(input_channels, enc_ch, (0.0, 0.0, 0.0), padding_mode)
        self.noisy_proj = ConvBlock(3 * enc_ch, base_ch, 1, act_type="relu")
        self.aux_enc = MultiScaleEncoder(aux_input_channels, enc_ch, (0.0, 0.2, 0.2),
                                         padding_mode)
        self.aux_proj1 = ConvBlock(3 * enc_ch, base_ch, 1, act_type="leakyrelu")
        self.aux_proj2 = ConvBlock(base_ch, base_ch, 1, act_type="leakyrelu")
        self.blocks = nn.ModuleList(
            MambaBlock(base_ch, d_state, d_conv, expansion, headdim, padding_mode)
            for _ in range(num_blocks))
        dec = dict(padding=1, padding_mode=padding_mode, act_type="relu")
        self.decoder = nn.ModuleList([
            ConvBlock(base_ch, base_ch, 3, **dec), ConvBlock(base_ch, base_ch, 3, **dec),
            ConvBlock(base_ch, input_channels, 3, padding=1, padding_mode="zeros",
                      act_type="leakyrelu"),
        ])

    def forward(self, x: torch.Tensor, aux: torch.Tensor, arith: Arith) -> torch.Tensor:
        out = self.noisy_proj(self.noisy_enc(x, arith), arith)
        h, w = out.shape[1:3]
        out = out + torch.from_numpy(positional_encoding_2d(self.base_ch, h, w)).to(out.device)
        for blk in self.blocks:
            out, aux = blk(out, aux, arith)
        for conv in self.decoder:
            out = conv(out, arith)
        return out + x
