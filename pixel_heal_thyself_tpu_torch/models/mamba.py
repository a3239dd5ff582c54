"""Mamba2 state-space denoiser (PyTorch, NHWC).

Port of `pixel_heal_thyself_tpu/models/mamba.py`: the AFGSANet encoder /
decoder skeleton with a 2-D sinusoidal positional encoding after the
encoders and Mamba blocks in the middle (LayerNorm → raster-scan Mamba2 →
residual → residual two-conv FFN), `decoder(out) + noisy` residual.
Parameters are float32, compute runs in `dtype`. Two quirks of the
reference stay pinned, as in the JAX package:
- the aux branch is encoded but no block consumes it. The JAX program's
  compiler drops that dead branch; the port keeps its parameters and does
  not run it, which gives the same output;
- the final decoder conv is LeakyReLU(0.2)'d before the global residual.

Three switches pick the route through each Mamba2 layer, as in the JAX
package:
- `use_megakernel`: the fused layer interior (`ops/ssd_mega.py`, the port
  of the TPU `ssd_mega.fused_mamba_chain`) whenever `supports_shapes`
  admits the geometry; otherwise the literal chain (causal conv1d → SiLU →
  softplus dt → `ssd_chunked` → `RMSNormGated`);
- `use_pallas`: on the literal chain, the conv1d + SiLU as one fused op
  (`ops/conv_fused.py`, the port of the TPU `conv_pallas.
  fused_causal_conv1d_silu`) whenever its `supports_shapes` admits the
  geometry; otherwise `causal_depthwise_conv1d` and SiLU in the compute
  dtype (the two round differently in bf16);
- `use_kernels`: the fused interior and the fused conv through their
  kernels (K7 forward, K8 backward; K9 forward, K10 backward) for CUDA
  tensors and their plain versions for CPU tensors. False runs the plain
  versions on any device — the reference the kernels are held against on
  the card.

`forward(..., seq_axis=axis)` is the sequence-sharded mode
(`parallel/sequence.py`): the model runs on one rank's strip of rows of a
frame whose rows are split over the ranks of `axis` (a
`parallel.mesh.RowAxis`), and equals the unsharded model on the whole
frame: every padded conv exchanges row halos (`ops/padding.
make_row_halo_pad`), the positional encoding is the global table's slice
at the strip's rows, each Mamba2 layer's conv1d takes the previous rank's
last k-1 tokens and its SSD is `ops/ssd.ssd_sharded`. Under `seq_axis` a
layer takes the literal chain with the plain conv1d, whatever
`use_megakernel` and `use_pallas` say, as in the JAX package (its
megakernel gate excludes `seq_axis`, and the seq branch comes before the
fused conv's).

In grad mode the fused interior goes through `ssd_mega.MambaChainFn` (K7's
emit variant forward, K8 backward; the TPU custom VJP's pair), as
AFGSANet's block route goes through `TransformerBlockFn`; out of it, the
forward alone. The fused conv always goes through `conv_fused.
FusedConvSiluFn` (K9 forward, K10 backward), whose forward is the same in
and out of grad mode.
`num_gcp` checkpoints the last `num_gcp` blocks in grad mode (the
Functions' forwards are deterministic, so the recompute gives the same
values).
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pixel_heal_thyself_tpu_torch.models.afgsa import MultiScaleEncoder
from pixel_heal_thyself_tpu_torch.models.layers import ConvBlock
from pixel_heal_thyself_tpu_torch.ops import conv_fused, ssd_mega
from pixel_heal_thyself_tpu_torch.ops.conv import causal_depthwise_conv1d
from pixel_heal_thyself_tpu_torch.ops.padding import make_row_halo_pad
from pixel_heal_thyself_tpu_torch.ops.ssd import ssd_chunked, ssd_sharded


def mamba_prod_kwargs() -> dict:
    """`MambaDenoiserNet` kwargs of `-cn prod model=mamba` (trainer default:
    bf16, deterministic → replicate padding, use_pallas → the fused route
    through its kernels; the fused conv is off, as the JAX `MambaTrainer`
    hard-wires it). Held against the config layer in
    tests/test_torch_port_mamba_model.py."""
    return dict(
        input_channels=3, aux_input_channels=7, base_ch=256, enc_ch=256,
        num_blocks=5, d_state=64, d_conv=4, expansion=4, headdim=64, num_gcp=0,
        padding_mode="replicate", use_kernels=True, use_megakernel=True,
        use_pallas=False, dtype=torch.bfloat16,
    )


def _uniform_(t: torch.Tensor, bound: float, generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class RMSNormGated(nn.Module):
    """RMSNorm(x · silu(z)) with a learned scale — Mamba2's gated norm. The
    mean square is f32; in bf16 the scale multiply runs in bf16, as the JAX
    module does."""

    def __init__(self, d: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        x = x * F.silu(z)
        xf = x.float()
        rms = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        if x.dtype == torch.float32:
            return xf * rms * self.weight
        return x * (rms.to(x.dtype) * self.weight.to(x.dtype))


class LayerNormTorch(nn.Module):
    """torch nn.LayerNorm parity (elementwise affine, eps 1e-5) with the JAX
    module's precision: f32 statistics and f32 `(x - mean)` (in bf16 a
    rewrite as x·inv − mean·inv cancels when |mean| ≫ σ); in bf16 only the
    affine output runs in bf16."""

    def __init__(self, d: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        inv = torch.rsqrt(var + self.eps)
        if self.dtype == torch.float32:
            return (xf - mean) * inv * self.scale + self.bias
        xn = ((xf - mean) * inv).to(self.dtype)
        return xn * self.scale.to(self.dtype) + self.bias.to(self.dtype)


class Mamba2Layer(nn.Module):
    """Sequence mixer [b, l, d_model] → [b, l, d_model]: in_proj → (z, xBC,
    dt) → the layer interior (fused or literal, see the module docstring)
    → out_proj. ngroups 1; the chunk of the SSD is fixed at 128."""

    chunk_size = 128

    def __init__(
        self, d_model: int, d_state: int = 64, d_conv: int = 4, expand: int = 4,
        headdim: int = 64, dt_min: float = 0.001, dt_max: float = 0.1,
        A_init_range: tuple = (1.0, 16.0), dtype: torch.dtype = torch.float32,
        use_kernels: bool = False, use_megakernel: bool = False, use_pallas: bool = False,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        d_inner = expand * d_model
        if d_inner % headdim:
            raise ValueError(f"d_inner {d_inner} is not a multiple of headdim {headdim}")
        self.d_model, self.d_state, self.d_conv, self.headdim = d_model, d_state, d_conv, headdim
        self.d_inner, self.nheads = d_inner, d_inner // headdim
        self.conv_dim = d_inner + 2 * d_state
        self.dtype = dtype
        self.use_kernels, self.use_megakernel = use_kernels, use_megakernel
        self.use_pallas = use_pallas
        g = generator
        self.in_proj = nn.Linear(d_model, 2 * d_inner + 2 * d_state + self.nheads, bias=False)
        _uniform_(self.in_proj.weight, 1.0 / math.sqrt(d_model), g)
        self.conv1d_weight = nn.Parameter(torch.empty(d_conv, self.conv_dim))
        _uniform_(self.conv1d_weight, 1.0 / math.sqrt(d_conv), g)
        self.conv1d_bias = nn.Parameter(torch.empty(self.conv_dim))
        _uniform_(self.conv1d_bias, 1.0 / math.sqrt(d_conv), g)
        # dt bias: inverse softplus of log-uniform [dt_min, dt_max]
        r = torch.rand(self.nheads, generator=g)
        dt = torch.exp(r * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
        dt = dt.clamp_min(1e-4)
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        lo, hi = A_init_range
        self.A_log = nn.Parameter(torch.log(lo + (hi - lo) * torch.rand(self.nheads, generator=g)))
        self.D = nn.Parameter(torch.ones(self.nheads))
        self.norm = RMSNormGated(d_inner)
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)
        _uniform_(self.out_proj.weight, 1.0 / math.sqrt(d_inner), g)

    def fused_route(self, l: int, seq_axis=None) -> bool:
        """Whether a sequence of length `l` takes the fused interior: never
        in the sequence-sharded mode (the JAX gate, `models/mamba.py:169`)."""
        return seq_axis is None and self.use_megakernel and ssd_mega.supports_shapes(
            l, self.d_inner, 1, self.d_state, self.headdim, self.d_conv, self.chunk_size,
        )

    def fused_conv_route(self, l: int) -> bool:
        """Whether the literal chain of a length-`l` sequence takes the fused
        conv1d + SiLU (the JAX gate, `models/mamba.py:209-214`)."""
        return self.use_pallas and conv_fused.supports_shapes(
            l, self.d_inner, self.conv_dim, self.d_conv, conv_fused.pick_l_tile(l),
        )

    def forward(self, u: torch.Tensor, seq_axis=None) -> torch.Tensor:
        b, l, _ = u.shape
        di, n, h, p = self.d_inner, self.d_state, self.nheads, self.headdim
        zxbcdt = F.linear(u.to(self.dtype), self.in_proj.weight.to(self.dtype))
        A = -torch.exp(self.A_log)
        if self.fused_route(l, seq_axis):
            params = (self.conv1d_weight, self.conv1d_bias, self.dt_bias, A, self.D,
                      self.norm.weight)
            if torch.is_grad_enabled():
                cfg = ssd_mega.MambaChainConfig(di, n, p, self.chunk_size, self.use_kernels)
                y = ssd_mega.MambaChainFn.apply(cfg, zxbcdt.contiguous(), *params)
            else:
                chain = (ssd_mega.fused_mamba_chain if self.use_kernels
                         else ssd_mega.fused_mamba_chain_torch)
                y = chain(zxbcdt.contiguous(), *params, d_inner=di, d_state=n, headdim=p,
                          chunk=self.chunk_size)
        else:
            z = zxbcdt[..., :di]
            xbc = zxbcdt[..., di:di + self.conv_dim]
            sharded_conv = seq_axis is not None and self.d_conv > 1
            if not sharded_conv and self.fused_conv_route(l):
                # its forward is the same in and out of grad mode
                xbc = conv_fused.FusedConvSiluFn.apply(
                    zxbcdt, self.conv1d_weight, self.conv1d_bias, di, self.conv_dim,
                    self.use_kernels,
                )
            else:
                # sharded: the previous rank's last k-1 tokens; rank 0 has
                # none, the global causal zero pad
                tail = (seq_axis.exchange(xbc[:, -(self.d_conv - 1):], None)[0]
                        if sharded_conv else None)
                xbc = F.silu(causal_depthwise_conv1d(
                    xbc, self.conv1d_weight, self.conv1d_bias, initial_tokens=tail,
                ))
            x, B, C = torch.split(xbc, [di, n, n], dim=-1)
            dt = ssd_mega.softplus(zxbcdt[..., di + self.conv_dim:].float() + self.dt_bias)
            ssd = ssd_chunked if seq_axis is None else partial(ssd_sharded, axis=seq_axis)
            y = ssd(
                x.reshape(b, l, h, p), dt.to(self.dtype), A.to(self.dtype),
                B.reshape(b, l, 1, n), C.reshape(b, l, 1, n), self.D.to(self.dtype),
                chunk=self.chunk_size,
            ).reshape(b, l, di)
            y = self.norm(y, z)
        return F.linear(y, self.out_proj.weight.to(self.dtype))


class MambaBlock(nn.Module):
    """LayerNorm → raster-scan Mamba2 → residual → residual two-conv FFN,
    carrying the (noisy, aux) pair; aux passes through untouched.
    `seq_axis`/`pad_fn`: the sequence-sharded mode (see the module
    docstring)."""

    def __init__(
        self, ch: int, d_state: int = 64, d_conv: int = 4, expansion: int = 4,
        headdim: int = 64, padding_mode: str = "reflect", dtype: torch.dtype = torch.float32,
        use_kernels: bool = False, use_megakernel: bool = False, use_pallas: bool = False,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.norm1 = LayerNormTorch(ch, dtype=dtype)
        self.mamba = Mamba2Layer(
            ch, d_state=d_state, d_conv=d_conv, expand=expansion, headdim=headdim,
            dtype=dtype, use_kernels=use_kernels, use_megakernel=use_megakernel,
            use_pallas=use_pallas, generator=generator,
        )
        conv = dict(padding=1, padding_mode=padding_mode, act_type="relu", dtype=dtype,
                    generator=generator)
        self.ffn1 = ConvBlock(ch, ch, 3, **conv)
        self.ffn2 = ConvBlock(ch, ch, 3, **conv)

    def forward(self, noisy: torch.Tensor, aux: torch.Tensor, seq_axis=None, pad_fn=None):
        b, h, w, c = noisy.shape
        mixed = self.mamba(self.norm1(noisy.reshape(b, h * w, c)), seq_axis)
        noisy = noisy + mixed.reshape(b, h, w, c)
        return noisy + self.ffn2(self.ffn1(noisy, pad_fn), pad_fn), aux


def positional_encoding_2d(channels: int, height: int, width: int) -> np.ndarray:
    """Sinusoidal 2-D encoding [H, W, C] (reference `mamba/model.py:296-324`):
    even channels sin(y·ω_k), odd channels cos(x·ω_k)."""
    pe = np.zeros((channels, height, width), np.float32)
    y_pos = np.repeat(np.arange(height)[:, None], width, axis=1)
    x_pos = np.repeat(np.arange(width)[None, :], height, axis=0)
    div = np.exp(np.arange(0, channels, 2) * -(math.log(10000.0) / channels))
    pe[0::2] = np.sin(y_pos[None, :, :] * div[:, None, None])
    pe[1::2] = np.cos(x_pos[None, :, :] * div[: channels // 2, None, None])
    # contiguous: in an exported graph (serving.py) it is a constant, saved whole
    return np.ascontiguousarray(pe.transpose(1, 2, 0))


class MambaDenoiserNet(nn.Module):
    """Multi-scale conv encoders + positional encoding + Mamba blocks +
    decoder with a global residual."""

    def __init__(
        self, input_channels=3, aux_input_channels=7, base_ch=256, num_blocks=5,
        d_state=64, d_conv=4, expansion=4, headdim=64, num_gcp=2, padding_mode="reflect",
        enc_ch=256, use_kernels=False, use_megakernel=False, use_pallas=False,
        dtype=torch.float32, device=None, generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if num_gcp > num_blocks:
            raise ValueError(f"num_gcp={num_gcp} > num_blocks={num_blocks}")
        self.base_ch = base_ch
        self.num_gcp = num_gcp
        self.dtype = dtype
        g = generator
        cb = dict(dtype=dtype, generator=g)
        self.noisy_enc = MultiScaleEncoder(input_channels, enc_ch, (0.0, 0.0, 0.0),
                                           padding_mode, dtype, g)
        self.noisy_proj = ConvBlock(3 * enc_ch, base_ch, 1, act_type="relu", **cb)
        # the aux encoder: parameters only (see the module docstring)
        self.aux_enc = MultiScaleEncoder(aux_input_channels, enc_ch, (0.0, 0.2, 0.2),
                                         padding_mode, dtype, g)
        self.aux_proj1 = ConvBlock(3 * enc_ch, base_ch, 1, act_type="leakyrelu", **cb)
        self.aux_proj2 = ConvBlock(base_ch, base_ch, 1, act_type="leakyrelu", **cb)
        self.blocks = nn.ModuleList(
            MambaBlock(base_ch, d_state=d_state, d_conv=d_conv, expansion=expansion,
                       headdim=headdim, padding_mode=padding_mode, use_kernels=use_kernels,
                       use_megakernel=use_megakernel, use_pallas=use_pallas, **cb)
            for _ in range(num_blocks)
        )
        dec = dict(padding=1, padding_mode=padding_mode, act_type="relu", **cb)
        self.decoder = nn.ModuleList([
            ConvBlock(base_ch, base_ch, 3, **dec),
            ConvBlock(base_ch, base_ch, 3, **dec),
            # reference quirk: act None falls into LeakyReLU(0.2)
            ConvBlock(base_ch, input_channels, 3, padding=1, padding_mode="zeros",
                      act_type="leakyrelu", **cb),
        ])
        # the positional encoding per (h, w, device): a constant of the
        # JAX program, built once here rather than on the host per call
        self._pe: dict[tuple, torch.Tensor] = {}
        if device is not None:
            self.to(device)

    def positional_encoding(self, h: int, w: int, device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._pe:
            pe = positional_encoding_2d(self.base_ch, h, w)
            self._pe[key] = torch.from_numpy(pe).to(device=device, dtype=self.dtype)
        return self._pe[key]

    def forward(self, x: torch.Tensor, aux: torch.Tensor, seq_axis=None) -> torch.Tensor:
        """`seq_axis`: the sequence-sharded mode, x and aux being this
        rank's strip of rows (module docstring)."""
        pad_fn = None if seq_axis is None else make_row_halo_pad(seq_axis)
        out = self.noisy_proj(self.noisy_enc(x.to(self.dtype), pad_fn), pad_fn)
        h, w = out.shape[1:3]
        if seq_axis is None:
            pe = self.positional_encoding(h, w, out.device)
        else:  # this strip's rows of the whole frame's table
            pe = self.positional_encoding(h * seq_axis.size, w, out.device)
            pe = pe[seq_axis.index * h:(seq_axis.index + 1) * h]
        out = out + pe
        first_gcp = len(self.blocks) - self.num_gcp
        for i, blk in enumerate(self.blocks):
            if i >= first_gcp and torch.is_grad_enabled():
                out, aux = checkpoint(blk, out, aux, seq_axis, pad_fn, use_reentrant=False)
            else:
                out, aux = blk(out, aux, seq_axis, pad_fn)
        for conv in self.decoder:
            out = conv(out, pad_fn)
        return out.float() + x.float()
