"""AFGSA windowed-attention denoiser (PyTorch, NHWC).

Port of `pixel_heal_thyself_tpu/models/afgsa.py`: multi-scale 1/3/5
encoders for the noisy and aux branches, N TransformerBlocks (attention
residual + two-conv feed-forward residual), a 3-conv decoder and a global
residual to the noisy input. Parameters are float32, compute runs in
`dtype`; every public function takes and returns NHWC.

Two switches pick the route through each TransformerBlock, as in the JAX
package:
- `use_block_kernel`: the whole-block route (`ops/block_cuda.py`, the
  port of the TPU `_block_kernel`) whenever `supports_shapes` admits the
  geometry and dtype and FiLM is off; otherwise the literal route
  (AFGSA module → residual → two ConvBlocks).
- `use_kernels`: route through the CUDA kernels' dispatchers (kernels for
  CUDA tensors, plain versions for CPU tensors). False calls the plain
  versions directly on any device — the reference the kernels are held
  against on the card.

In grad mode the kernel routes run through the differentiable ops whose
backward is a kernel too: `TransformerBlockFn` (K6/K5/K4/K2) on the block
route, `BlockHaloAttentionFn` (K1 forward, K4 backward) on the literal
route. The block route with `use_kernels=False` runs the same Function on
the plain versions, so the two routes share one algorithm.

`num_gcp` checkpoints the last `num_gcp` blocks with
`torch.utils.checkpoint` (flax `nn.remat` in the JAX package): their
activations are recomputed in the backward instead of kept.

`fold_qkv` folds the q/k/v projections into the attention op
(`QKVBlockHaloAttentionFn`, the TPU `qkv_block_halo_attention_pallas`)
under the JAX gate: `use_kernels`, `fold_qkv` and a channel count that is
a multiple of 128, on the literal route only (the block route takes
precedence and ignores it, as in JAX).

`use_film` fuses the noisy and aux features with FiLM (JAX
`models/afgsa.py:58`: cond = aux → 1×1 conv to 128 → ReLU → 1×1 conv to
2·ch, spatial γ, β; γ·noisy + β) instead of the 1×1 ConvBlock over their
concat. Under FiLM every block takes the literal route, whatever
`use_block_kernel` says (the whole-block kernel has no FiLM), as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pixel_heal_thyself_tpu_torch.ops.curves import CurveOrder
from pixel_heal_thyself_tpu_torch.models.layers import Conv, ConvBlock, apply_act, conv_nhwc
from pixel_heal_thyself_tpu_torch.ops.attention import (
    BlockHaloAttentionFn,
    QKVBlockHaloAttentionFn,
    block_halo_attention,
    block_halo_attention_torch,
)
from pixel_heal_thyself_tpu_torch.ops.block_cuda import (
    BlockConfig,
    TransformerBlockFn,
    kernel_layout,
    supports_shapes,
    transformer_block_fwd,
    transformer_block_torch,
)
from pixel_heal_thyself_tpu_torch.ops.padding import pad2d
from pixel_heal_thyself_tpu_torch.utils.init import kaiming_normal_fan_out_, normal_unit_


def afgsa_prod_kwargs() -> dict:
    """`AFGSANet` kwargs of `-cn prod` (model afgsa, trainer default:
    bf16, deterministic → replicate padding, use_pallas → kernels and the
    block route). Held against the config layer in
    tests/test_torch_port_afgsa.py."""
    return dict(
        input_channels=3, aux_input_channels=7, base_ch=256, enc_ch=256,
        num_sa=5, block_size=8, halo_size=3, num_heads=4, num_gcp=0,
        padding_mode="replicate", curve_order=CurveOrder.RASTER,
        use_film=False, fold_qkv=False, use_kernels=True,
        use_block_kernel=True, dtype=torch.bfloat16,
    )


def multi_scale_encode(
    x: torch.Tensor, convs, slopes: tuple, padding_mode: str, dtype: torch.dtype,
    pad_fn=None,
) -> torch.Tensor:
    """The three parallel 1×1/3×3/5×5 encoder convs as ONE 5×5 conv whose
    kernel is the branch kernels zero-embedded in 5×5 envelopes and
    concatenated along the outputs (exact: embedded zeros contribute
    nothing, and padding values at distance d do not depend on the pad
    width). `slopes` are the per-branch leaky-relu slopes (0 = relu).
    `pad_fn` replaces `pad2d` as in `ConvBlock`; under the row-halo
    exchange the pad-2 rows are the true neighbour rows, whose inner ring
    is the pad-1 rows, so the merged conv stays exact."""
    kernels, biases = [], []
    for conv in convs:
        p = (5 - conv.weight.shape[-1]) // 2
        kernels.append(nn.functional.pad(conv.weight, (p, p, p, p)))
        biases.append(conv.bias)
    kernel = torch.cat(kernels, dim=0)
    bias = torch.cat(biases).to(dtype)
    pad = pad2d if pad_fn is None else pad_fn
    y = conv_nhwc(pad(x, 2, padding_mode), kernel, dtype) + bias
    if all(s == slopes[0] for s in slopes):
        return apply_act(y, "relu" if slopes[0] == 0.0 else "leakyrelu")
    e = convs[0].weight.shape[0]
    slope = torch.tensor(slopes, dtype=dtype, device=y.device).repeat_interleave(e)
    return torch.where(y >= 0, y, slope * y)


class MultiScaleEncoder(nn.Module):
    """Holds the three encoder branch convs (k = 1, 3, 5)."""

    def __init__(self, in_ch, features, slopes, padding_mode, dtype, generator):
        super().__init__()
        self.slopes = tuple(slopes)
        self.padding_mode = padding_mode
        self.dtype = dtype
        self.branches = nn.ModuleList(
            Conv(in_ch, features, k, dtype=dtype, generator=generator) for k in (1, 3, 5)
        )

    def forward(self, x: torch.Tensor, pad_fn=None) -> torch.Tensor:
        return multi_scale_encode(x, self.branches, self.slopes, self.padding_mode, self.dtype,
                                  pad_fn)


class FiLM(nn.Module):
    """Feature-wise linear modulation, spatial (SPADE-like), as AFGSA uses
    it (`use_spatial=True` in the JAX package, the only setting it takes):
    γ, β = split(conv1(relu(conv0(cond)))) per pixel; returns γ·x + β in
    `dtype`."""

    def __init__(self, ch: int, cond_ch: int, hidden: int = 128, dtype=torch.float32,
                 generator=None) -> None:
        super().__init__()
        self.conv0 = Conv(cond_ch, hidden, 1, dtype=dtype, generator=generator)
        self.conv1 = Conv(hidden, 2 * ch, 1, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.conv1(torch.relu(self.conv0(cond))).chunk(2, dim=-1)
        return gamma * x + beta


class AFGSA(nn.Module):
    """Auxiliary-feature-guided self-attention: fuse noisy+aux (1×1 conv
    over the concat, or FiLM of noisy by aux), bias-free 1×1 q/k
    projections of the fused features and v of the noisy ones, then
    block-halo attention (the projections folded into the attention op
    when `folded`)."""

    def __init__(
        self, ch: int, noisy_ch: int, aux_ch: int, *, block_size=8, halo_size=3,
        num_heads=4, curve_order=CurveOrder.RASTER, use_film=False, fold_qkv=False,
        use_kernels=False, dtype=torch.float32, generator=None,
    ) -> None:
        super().__init__()
        if ch % num_heads:
            raise ValueError("ch should be divided by # heads")
        head_ch = ch // num_heads
        window = block_size + 2 * halo_size
        del curve_order  # an exact no-op for attention, see ops/attention.py
        self.block_size, self.halo_size, self.num_heads = block_size, halo_size, num_heads
        self.use_kernels = use_kernels
        # the JAX gate (models/afgsa.py:350), use_pallas being use_kernels
        self.folded = use_kernels and fold_qkv and ch % 128 == 0
        self.dtype = dtype
        self.use_film = use_film
        if use_film:
            self.film = FiLM(noisy_ch, aux_ch, hidden=128, dtype=dtype, generator=generator)
        else:
            self.fuse = ConvBlock(noisy_ch + aux_ch, ch, 1, act_type="relu", dtype=dtype,
                                  generator=generator)
        self.q_weight = nn.Parameter(torch.empty(ch, ch, 1, 1))
        self.k_weight = nn.Parameter(torch.empty(ch, ch, 1, 1))
        self.v_weight = nn.Parameter(torch.empty(ch, noisy_ch, 1, 1))
        self.rel_h = nn.Parameter(torch.empty(window, head_ch // 2))
        self.rel_w = nn.Parameter(torch.empty(window, head_ch // 2))
        for w in (self.q_weight, self.k_weight, self.v_weight):
            kaiming_normal_fan_out_(w, generator)
        normal_unit_(self.rel_h, generator)
        normal_unit_(self.rel_w, generator)

    def forward(self, noisy: torch.Tensor, aux: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.use_film:
            n_aux = self.film(noisy.to(self.dtype), aux)
        else:
            n_aux = self.fuse(torch.cat([noisy, aux], dim=-1))
        if self.folded:
            w = (t[:, :, 0, 0].t() for t in (self.q_weight, self.k_weight, self.v_weight))
            return QKVBlockHaloAttentionFn.apply(
                n_aux.contiguous(), noisy.to(self.dtype).contiguous(), *w, self.rel_h,
                self.rel_w, None if residual is None else residual.contiguous(),
                self.block_size, self.halo_size, self.num_heads,
            )
        q = conv_nhwc(n_aux, self.q_weight, self.dtype).contiguous()
        k = conv_nhwc(n_aux, self.k_weight, self.dtype).contiguous()
        v = conv_nhwc(noisy, self.v_weight, self.dtype).contiguous()
        residual = None if residual is None else residual.contiguous()
        if self.use_kernels and torch.is_grad_enabled():
            return BlockHaloAttentionFn.apply(
                q, k, v, self.rel_h, self.rel_w, residual,
                self.block_size, self.halo_size, self.num_heads,
            )
        attn = block_halo_attention if self.use_kernels else block_halo_attention_torch
        return attn(
            q, k, v, self.rel_h, self.rel_w, block_size=self.block_size,
            halo_size=self.halo_size, num_heads=self.num_heads, residual=residual,
        )


class TransformerBlock(nn.Module):
    """Residual attention + residual two-conv feed-forward, carrying the
    (noisy, aux) pair. `forward(..., use_block_kernel=True)` takes the
    whole-block route (the caller has checked `supports_shapes`)."""

    def __init__(
        self, ch: int, *, block_size=8, halo_size=3, num_heads=4,
        padding_mode="reflect", curve_order=CurveOrder.RASTER, use_film=False,
        fold_qkv=False, use_kernels=False, dtype=torch.float32, generator=None,
    ) -> None:
        super().__init__()
        self.padding_mode = padding_mode
        self.use_kernels = use_kernels
        self.dtype = dtype
        self.attention = AFGSA(
            ch, ch, ch, block_size=block_size, halo_size=halo_size,
            num_heads=num_heads, curve_order=curve_order, use_film=use_film,
            fold_qkv=fold_qkv, use_kernels=use_kernels, dtype=dtype,
            generator=generator,
        )
        conv = dict(padding=1, padding_mode=padding_mode, act_type="relu", dtype=dtype,
                    generator=generator)
        self.ffn1 = ConvBlock(ch, ch, 3, **conv)
        self.ffn2 = ConvBlock(ch, ch, 3, **conv)

    def block_params(self) -> tuple:
        """The block's parameters in `ops.block_cuda.PARAM_NAMES` order
        (not under FiLM, which the whole-block route does not take)."""
        att = self.attention
        return (
            att.fuse.conv.weight, att.fuse.conv.bias, att.q_weight, att.k_weight,
            att.v_weight, att.rel_h, att.rel_w, self.ffn1.conv.weight,
            self.ffn1.conv.bias, self.ffn2.conv.weight, self.ffn2.conv.bias,
        )

    def kernel_weights(self) -> dict:
        """The block's weights in the layout `ops/block_cuda.py` takes."""
        return kernel_layout(self.dtype, *self.block_params())

    def forward(self, noisy: torch.Tensor, aux: torch.Tensor, *,
                use_block_kernel: bool = False):
        att = self.attention
        if use_block_kernel:
            x = noisy.to(self.dtype).contiguous()
            a = aux.to(self.dtype).contiguous()
            cfg = BlockConfig(att.block_size, att.halo_size, att.num_heads,
                              self.padding_mode, self.use_kernels)
            if torch.is_grad_enabled():
                return TransformerBlockFn.apply(cfg, x, a, *self.block_params()), aux
            block = transformer_block_fwd if self.use_kernels else transformer_block_torch
            out = block(
                x, a, **self.kernel_weights(), block_size=att.block_size,
                halo_size=att.halo_size, num_heads=att.num_heads,
                padding_mode=self.padding_mode,
            )
            return out, aux
        noisy = self.attention(noisy, aux, residual=noisy)
        return noisy + self.ffn2(self.ffn1(noisy)), aux


class AFGSANet(nn.Module):
    """The AFGSA generator: multi-scale encoders → N TransformerBlocks →
    decoder with a global residual; the last `num_gcp` blocks are
    gradient-checkpointed in grad mode."""

    def __init__(
        self, input_channels=3, aux_input_channels=7, base_ch=256, num_sa=5,
        block_size=8, halo_size=3, num_heads=4, num_gcp=2, padding_mode="reflect",
        curve_order=CurveOrder.RASTER, use_film=False, fold_qkv=False,
        use_kernels=False, use_block_kernel=False, enc_ch=256,
        dtype=torch.float32, device=None, generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if num_gcp > num_sa:
            raise ValueError(f"num_gcp={num_gcp} > num_sa={num_sa}")
        self.base_ch = base_ch
        self.num_gcp = num_gcp
        self.block_size, self.halo_size, self.num_heads = block_size, halo_size, num_heads
        # the JAX rule (models/afgsa.py:527): no whole-block route under FiLM
        self.use_block_kernel = use_block_kernel and not use_film
        self.dtype = dtype
        g = generator
        cb = dict(dtype=dtype, generator=g)
        self.noisy_enc = MultiScaleEncoder(input_channels, enc_ch, (0.0, 0.0, 0.0),
                                           padding_mode, dtype, g)
        self.noisy_proj = ConvBlock(3 * enc_ch, base_ch, 1, act_type="relu", **cb)
        self.aux_enc = MultiScaleEncoder(aux_input_channels, enc_ch, (0.0, 0.2, 0.2),
                                         padding_mode, dtype, g)
        self.aux_proj1 = ConvBlock(3 * enc_ch, base_ch, 1, act_type="leakyrelu", **cb)
        self.aux_proj2 = ConvBlock(base_ch, base_ch, 1, act_type="leakyrelu", **cb)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                base_ch, block_size=block_size, halo_size=halo_size,
                num_heads=num_heads, padding_mode=padding_mode,
                curve_order=curve_order, use_film=use_film, fold_qkv=fold_qkv,
                use_kernels=use_kernels, **cb,
            )
            for _ in range(num_sa)
        )
        dec = dict(padding=1, padding_mode=padding_mode, act_type="relu", **cb)
        self.decoder = nn.ModuleList([
            ConvBlock(base_ch, base_ch, 3, **dec),
            ConvBlock(base_ch, base_ch, 3, **dec),
            ConvBlock(base_ch, input_channels, 3, padding=1, padding_mode="zeros",
                      act_type=None, **cb),
        ])
        if device is not None:
            self.to(device)

    def block_route(self, b: int, h: int, w: int) -> bool:
        """Whether blocks of a [b, h, w] feature map take the block route."""
        return self.use_block_kernel and supports_shapes(
            b, h, w, self.base_ch, block_size=self.block_size,
            halo_size=self.halo_size, num_heads=self.num_heads, dtype=self.dtype,
        )

    def forward(self, x: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        aux = aux.to(self.dtype)
        out = self.noisy_proj(self.noisy_enc(x))
        a = self.aux_proj2(self.aux_proj1(self.aux_enc(aux)))
        use_block = self.block_route(*out.shape[:3])
        first_gcp = len(self.blocks) - self.num_gcp
        for i, blk in enumerate(self.blocks):
            if i >= first_gcp and torch.is_grad_enabled():
                out, a = checkpoint(blk, out, a, use_block_kernel=use_block,
                                    use_reentrant=False)
            else:
                out, a = blk(out, a, use_block_kernel=use_block)
        for conv in self.decoder:
            out = conv(out)
        # global residual in fp32
        return out.float() + x.float()


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
