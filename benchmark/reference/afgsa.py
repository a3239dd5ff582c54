"""Plain reference of the AFGSA generator (AFGSANet), NHWC, float32.

The semantics of the program's generator, written out in plain PyTorch:
multi-scale 1/3/5 encoders of the noisy radiance and of the aux buffers,
N TransformerBlocks, each the auxiliary-feature-guided attention with a
residual (1×1 fuse of noisy and aux features, bias-free 1×1 q/k of the
fused features and v of the noisy ones, block-halo attention) followed by a
residual two-conv feed-forward, and a 3-conv decoder with a global residual
to the noisy input (Yu et al., SIGGRAPH Asia 2021).

Block-halo attention: each block × block tile of queries attends to the
(block + 2·halo)² window of keys and values centred on it; keys and values
outside the frame are zero vectors that still take the relative bias and
the softmax. The relative bias adds `rel_h` (by the key's window row) to
the first half of each head's channels and `rel_w` (by its column) to the
second half, shared by the heads. Logits are scaled by head_ch^-0.5.

Parameter names equal the program's, so one seeded state dict loads into
both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nn import Arith, ConvBlock, MultiScaleEncoder, param


def halo_windows(x: torch.Tensor, block: int, halo: int) -> torch.Tensor:
    """[B, H, W, C] → [B, hb, wb, win, win, C] windows at stride `block`,
    zero outside the frame."""
    win = block + 2 * halo
    xp = F.pad(x, (0, 0, halo, halo, halo, halo))
    return xp.unfold(1, win, block).unfold(2, win, block).permute(0, 1, 2, 4, 5, 3)


def block_halo_attention(q, k, v, rel_h, rel_w, block: int, halo: int, heads: int,
                         arith: Arith) -> torch.Tensor:
    b, h, w, c = q.shape
    win, hd = block + 2 * halo, c // heads
    hb, wb, nq, nk = h // block, w // block, block * block, win * win
    qh = q.reshape(b, hb, block, wb, block, heads, hd).permute(0, 1, 3, 5, 2, 4, 6)
    qh = qh.reshape(b, hb, wb, heads, nq, hd)
    half = rel_h.shape[1]
    bias = torch.cat([rel_h[:, None, :].expand(win, win, half),
                      rel_w[None, :, :].expand(win, win, half)], dim=-1)
    kw = halo_windows(k, block, halo).reshape(b, hb, wb, win, win, heads, hd) + bias[:, :, None]
    kh = kw.reshape(b, hb, wb, nk, heads, hd).permute(0, 1, 2, 4, 3, 5)
    vh = halo_windows(v, block, halo).reshape(b, hb, wb, nk, heads, hd).permute(0, 1, 2, 4, 3, 5)
    logits = arith.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    out = arith.matmul(torch.softmax(logits, dim=-1), vh)        # [b,hb,wb,heads,nq,hd]
    out = out.reshape(b, hb, wb, heads, block, block, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return out.reshape(b, h, w, c)


class AFGSA(nn.Module):
    def __init__(self, ch: int, block: int, halo: int, heads: int) -> None:
        super().__init__()
        self.block, self.halo, self.heads = block, halo, heads
        win, hd = block + 2 * halo, ch // heads
        self.fuse = ConvBlock(2 * ch, ch, 1, act_type="relu")
        qk = ("uniform", math.sqrt(6.0 / ch))   # variance of N(0, 2/fan_out)
        for name in ("q_weight", "k_weight", "v_weight"):
            param(self, name, (ch, ch, 1, 1), qk)
        param(self, "rel_h", (win, hd // 2), ("uniform", math.sqrt(3.0)))  # variance 1
        param(self, "rel_w", (win, hd // 2), ("uniform", math.sqrt(3.0)))

    def forward(self, noisy, aux, arith: Arith):
        n_aux = self.fuse(torch.cat([noisy, aux], dim=-1), arith)
        q = arith.conv2d(n_aux, self.q_weight)
        k = arith.conv2d(n_aux, self.k_weight)
        v = arith.conv2d(noisy, self.v_weight)
        return noisy + block_halo_attention(q, k, v, self.rel_h, self.rel_w, self.block,
                                            self.halo, self.heads, arith)


class TransformerBlock(nn.Module):
    def __init__(self, ch: int, block: int, halo: int, heads: int, padding_mode: str) -> None:
        super().__init__()
        self.attention = AFGSA(ch, block, halo, heads)
        conv = dict(padding=1, padding_mode=padding_mode, act_type="relu")
        self.ffn1 = ConvBlock(ch, ch, 3, **conv)
        self.ffn2 = ConvBlock(ch, ch, 3, **conv)

    def forward(self, noisy, aux, arith: Arith):
        noisy = self.attention(noisy, aux, arith)
        return noisy + self.ffn2(self.ffn1(noisy, arith), arith), aux


class AFGSANet(nn.Module):
    def __init__(self, *, input_channels: int, aux_input_channels: int, base_ch: int,
                 enc_ch: int, num_blocks: int, block_size: int, halo_size: int, num_heads: int,
                 padding_mode: str) -> None:
        super().__init__()
        self.noisy_enc = MultiScaleEncoder(input_channels, enc_ch, (0.0, 0.0, 0.0), padding_mode)
        self.noisy_proj = ConvBlock(3 * enc_ch, base_ch, 1, act_type="relu")
        self.aux_enc = MultiScaleEncoder(aux_input_channels, enc_ch, (0.0, 0.2, 0.2),
                                         padding_mode)
        self.aux_proj1 = ConvBlock(3 * enc_ch, base_ch, 1, act_type="leakyrelu")
        self.aux_proj2 = ConvBlock(base_ch, base_ch, 1, act_type="leakyrelu")
        self.blocks = nn.ModuleList(
            TransformerBlock(base_ch, block_size, halo_size, num_heads, padding_mode)
            for _ in range(num_blocks))
        dec = dict(padding=1, padding_mode=padding_mode, act_type="relu")
        self.decoder = nn.ModuleList([
            ConvBlock(base_ch, base_ch, 3, **dec), ConvBlock(base_ch, base_ch, 3, **dec),
            ConvBlock(base_ch, input_channels, 3, padding=1, padding_mode="zeros",
                      act_type=None),
        ])

    def forward(self, x: torch.Tensor, aux: torch.Tensor, arith: Arith) -> torch.Tensor:
        out = self.noisy_proj(self.noisy_enc(x, arith), arith)
        a = self.aux_proj2(self.aux_proj1(self.aux_enc(aux, arith), arith), arith)
        for blk in self.blocks:
            out, a = blk(out, a, arith)
        for conv in self.decoder:
            out = conv(out, arith)
        return out + x
