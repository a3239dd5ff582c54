"""Fused causal depthwise conv1d + bias + SiLU over a column window of the
Mamba2 in-projection output (port of `pixel_heal_thyself_tpu/ops/
conv_pallas.py`).

    y = silu(causal_depthwise_conv1d(zxbcdt[..., offset:offset + width], w, b))

without slicing the window out of zxbcdt. The taps accumulate in f32 in the
TPU kernel's order (`w[k-1]·x`, then tap t = 0..k-2 on the input shifted
right by k-1-t, then the bias; `_conv_rows` :133) and the result is rounded
to zxbcdt's dtype once, after the SiLU (`_fwd_kernel` :155). So in bf16
this is not `ops.conv.causal_depthwise_conv1d` + SiLU, which round at every
step in x's dtype; in float32 the two agree.

The backward recomputes the pre-activation, forms dpre = dy·silu'(pre)
with dy rounded to the input dtype first (`_vjp_bwd` :346), and returns dx
in the input dtype with the f32 tap and bias gradients summed over the
whole sequence and batch (`_bwd_kernel` :212, `_bwd` :312). Rows outside
[0, l) read as zero. The TPU kernel's row tiles and 8-row context are
layout, not semantics: these functions are global over the sequence.

- `supports_shapes`, `pick_l_tile`: the JAX gate (`conv_pallas.py:45-60`),
  so that the Mamba2 layer takes the fused route exactly where JAX does.
- `fused_causal_conv1d_silu_torch`, `fused_causal_conv1d_silu_bwd_torch`:
  the plain versions.
- `fused_causal_conv1d_silu`, `fused_causal_conv1d_silu_bwd`: dispatchers,
  the kernels K9/K10 (`ops/conv_cuda.py`) for CUDA tensors and the plain
  versions for CPU tensors; not differentiable.
- `FusedConvSiluFn`: the differentiable op, the TPU custom VJP's boundary
  (`:316-354`): (zxbcdt, w, b) in, [b, l, width] out; the gradient of
  zxbcdt is the window's, zero-padded over the other columns (`:350`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pixel_heal_thyself_tpu_torch._build import dispatch
from pixel_heal_thyself_tpu_torch.ops.conv_cuda import (
    fused_causal_conv1d_silu_bwd_cuda,
    fused_causal_conv1d_silu_cuda,
)

_CTX = 8  # the TPU kernel's loaded context rows (>= k - 1, a sublane tile)


def supports_shapes(l: int, offset: int, width: int, k: int, l_tile: int) -> bool:
    """The JAX gate of the fused route (`conv_pallas.supports_shapes`)."""
    return (
        k <= _CTX + 1
        and offset % 128 == 0
        and width % 128 == 0
        and l % l_tile == 0
        and l_tile % 8 == 0
    )


def pick_l_tile(l: int) -> int:
    """The JAX row tile (`conv_pallas._pick_l_tile`), which the gate reads."""
    for lt in (2048, 1024, 512, 256, 128, 64, 32, 16, 8):
        if l % lt == 0:
            return lt
    return l


def _pre(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 pre-activation of the f32 window x [b, l, width]."""
    k, l = w.shape[0], x.shape[1]
    w = w.float()
    xp = F.pad(x, (0, 0, k - 1, 0))
    acc = x * w[k - 1]
    for t in range(k - 1):
        acc = acc + xp[:, t:t + l] * w[t]
    return acc + b.float()


def fused_causal_conv1d_silu_torch(zxbcdt, w, b, offset: int, width: int) -> torch.Tensor:
    """Plain forward: zxbcdt [b, l, c], taps w [k, width] (tap 0 the oldest),
    bias b [width] → [b, l, width] in zxbcdt's dtype."""
    pre = _pre(zxbcdt[..., offset:offset + width].float(), w, b)
    return (pre * torch.sigmoid(pre)).to(zxbcdt.dtype)


def fused_causal_conv1d_silu_bwd_torch(zxbcdt, w, b, dy, offset: int, width: int) -> tuple:
    """Plain backward for the output gradient dy [b, l, width] → (dx [b,
    l, width] in zxbcdt's dtype, dw, db: f32 sums in their parameters'
    dtypes)."""
    dtype = zxbcdt.dtype
    k, l = w.shape[0], zxbcdt.shape[1]
    x = zxbcdt[..., offset:offset + width].float()
    pre = _pre(x, w, b)
    sig = torch.sigmoid(pre)
    dpre = dy.to(dtype).float() * (sig * (1 + pre * (1 - sig)))
    wf = w.float()
    dpp = F.pad(dpre, (0, 0, 0, k - 1))
    dx = dpre * wf[k - 1]
    for t in range(k - 1):
        s = k - 1 - t
        dx = dx + dpp[:, s:s + l] * wf[t]
    xp = F.pad(x, (0, 0, k - 1, 0))
    dw = torch.stack([(dpre * xp[:, t:t + l]).sum(dim=(0, 1)) for t in range(k)])
    return dx.to(dtype), dw.to(w.dtype), dpre.sum(dim=(0, 1)).to(b.dtype)


def fused_causal_conv1d_silu(zxbcdt, w, b, offset: int, width: int) -> torch.Tensor:
    """Dispatching forward: K9 for CUDA tensors (launch or raise), the plain
    version for CPU tensors. Not differentiable."""
    return dispatch("fused_causal_conv1d_silu", zxbcdt, fused_causal_conv1d_silu_cuda,
                    fused_causal_conv1d_silu_torch, zxbcdt, w, b, offset, width)


def fused_causal_conv1d_silu_bwd(zxbcdt, w, b, dy, offset: int, width: int) -> tuple:
    """Dispatching backward: K10 for CUDA tensors, the plain version for CPU
    tensors. Returns (dx, dw, db)."""
    return dispatch("fused_causal_conv1d_silu_bwd", zxbcdt, fused_causal_conv1d_silu_bwd_cuda,
                    fused_causal_conv1d_silu_bwd_torch, zxbcdt, w, b, dy, offset, width)


class FusedConvSiluFn(torch.autograd.Function):
    """Differentiable fused conv1d + SiLU (port of the TPU custom VJP
    `fused_causal_conv1d_silu`, `conv_pallas.py:316-354`).

    `apply(zxbcdt, w, b, offset, width, use_kernels)`: with `use_kernels`
    the forward and backward run the dispatchers (K9/K10 on the card),
    otherwise the plain versions on any device. The gradient of zxbcdt is
    the window's, zero-padded over the other columns. First-order only."""

    @staticmethod
    def forward(ctx, zxbcdt, w, b, offset, width, use_kernels):
        ctx.cfg = (offset, width, use_kernels)
        ctx.save_for_backward(zxbcdt, w, b)
        fwd = fused_causal_conv1d_silu if use_kernels else fused_causal_conv1d_silu_torch
        return fwd(zxbcdt, w, b, offset, width)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        zxbcdt, w, b = ctx.saved_tensors
        offset, width, use_kernels = ctx.cfg
        bwd = fused_causal_conv1d_silu_bwd if use_kernels else fused_causal_conv1d_silu_bwd_torch
        dx, dw, db = bwd(zxbcdt, w, b, dy.to(zxbcdt.dtype).contiguous(), offset, width)
        dz = F.pad(dx, (offset, zxbcdt.shape[-1] - offset - width))
        return dz, dw, db, None, None, None
