"""Wrappers of the fused causal-conv1d + SiLU kernels: the forward K9 and
the backward K10 (`csrc/conv_silu.cu`).

K9 replaces the TPU kernel `pixel_heal_thyself_tpu/ops/conv_pallas.py:147`
(`_fwd_kernel`) and K10 its backward `:158` (`_bwd_kernel`). Both read the
column window `[offset, offset + width)` straight out of zxbcdt; a CTA
takes `ROWS` (K9) or `BWD_ROWS` (K10) rows of one batch element. Each has
two bodies: the "vec" body (`conv_fwd_body`, `conv_bwd_body`: windows
whose offset, row stride and width are multiples of 16 bytes, the prod
window among them) gives a thread 4 channels and a copy ring of rows; the
general body gives it one channel. K10's tap and bias gradients go
through f32 partials per (batch, row tile), 23.6 MB at the prod shape (8
× 16,384 tokens, width 1152), added in a fixed order. The plain versions
are `ops.conv_fused.fused_causal_conv1d_silu_torch` and
`fused_causal_conv1d_silu_bwd_torch`.
`fused_causal_conv1d_silu_cuda.launches` and
`fused_causal_conv1d_silu_bwd_cuda.launches` count the calls that
launched, and `.body_launches` each body's. The wrappers pick the body
and name it to the C entry, which refuses a window the named body does
not take (the library's `pht_conv_silu_fwd_body` and
`pht_conv_silu_bwd_body` state the same rule; a card test holds them
equal).
"""

from __future__ import annotations

import torch

from pixel_heal_thyself_tpu_torch import _build

ROWS = 64  # rows of one batch element per CTA (K9)
BWD_ROWS = 128  # rows of one batch element per CTA (K10)


def _checked(what: str, zxbcdt, w, b, offset: int, width: int, *tensors) -> tuple:
    """Refuse what the kernels do not take; the f32 [k + 1, width] taps
    and bias, and (batch, length, columns, k)."""
    _build.refuse_autograd(what, zxbcdt, w, b, *tensors)
    if zxbcdt.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {zxbcdt.device}")
    if zxbcdt.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: dtype {zxbcdt.dtype} (bf16 or fp32)")
    if zxbcdt.dim() != 3 or not zxbcdt.is_contiguous():
        raise ValueError(f"{what} needs a contiguous [b, l, c] zxbcdt")
    bsz, l, ctot = zxbcdt.shape
    k = w.shape[0]
    if (tuple(w.shape) != (k, width) or tuple(b.shape) != (width,) or not 1 <= k <= 9
            or offset < 0 or offset + width > ctot or l == 0):
        raise ValueError(f"{what}: window [{offset}, {offset + width}) of {ctot} columns, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}, l {l}")
    wb = torch.cat([w.float(), b.float()[None]], dim=0).contiguous()
    return wb, bsz, l, ctot, k


def conv_bwd_body(dtype: torch.dtype, columns: int, offset: int, width: int,
                  aligned: bool = True) -> str:
    """The body K10 takes: "vec" where the window's offset, zxbcdt's row of
    `columns` and the width are multiples of 16 bytes and the tensors are
    16-byte aligned (csrc/conv_silu.cu `vec_body`); "general" otherwise."""
    per = 16 // torch.empty(0, dtype=dtype).element_size()
    vec = aligned and offset % per == 0 and columns % per == 0 and width % per == 0
    return "vec" if vec else "general"


def conv_fwd_body(dtype: torch.dtype, columns: int, offset: int, width: int,
                  aligned: bool = True) -> str:
    """The body K9 takes: K10's rule (`conv_bwd_body`)."""
    return conv_bwd_body(dtype, columns, offset, width, aligned)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def fused_causal_conv1d_silu_cuda(zxbcdt, w, b, offset: int, width: int) -> torch.Tensor:
    """Launch K9: zxbcdt [b, l, c] (bf16 or fp32, contiguous, on a CUDA
    device), taps w [k, width], bias b [width] → silu(conv(window)) [b, l,
    width] in zxbcdt's dtype."""
    wb, bsz, l, ctot, k = _checked("fused_causal_conv1d_silu_cuda", zxbcdt, w, b, offset, width)
    y = torch.empty(bsz, l, width, dtype=zxbcdt.dtype, device=zxbcdt.device)
    body = conv_fwd_body(zxbcdt.dtype, ctot, offset, width, _aligned(zxbcdt, wb, y))
    err = _build.lib().pht_conv_silu_fwd(
        zxbcdt.data_ptr(), wb.data_ptr(), y.data_ptr(), bsz, l, ctot, offset, width, k, ROWS,
        int(zxbcdt.dtype == torch.bfloat16), int(body == "vec"),
        torch.cuda.current_stream(zxbcdt.device).cuda_stream,
    )
    _build.check(err, "fused_causal_conv1d_silu_cuda")
    fused_causal_conv1d_silu_cuda.launches += 1
    fused_causal_conv1d_silu_cuda.body_launches[body] += 1
    return y


fused_causal_conv1d_silu_cuda.launches = 0
fused_causal_conv1d_silu_cuda.body_launches = {"vec": 0, "general": 0}


def fused_causal_conv1d_silu_bwd_cuda(zxbcdt, w, b, dy, offset: int, width: int) -> tuple:
    """Launch K10: the VJP of K9 for the output gradient dy [b, l, width]
    (rounded to zxbcdt's dtype first) → (dx [b, l, width] in zxbcdt's
    dtype, dw, db in their parameters' dtypes)."""
    what = "fused_causal_conv1d_silu_bwd_cuda"
    wb, bsz, l, ctot, k = _checked(what, zxbcdt, w, b, offset, width, dy)
    if tuple(dy.shape) != (bsz, l, width):
        raise ValueError(f"{what}: dy {tuple(dy.shape)}, want {(bsz, l, width)}")
    dev = zxbcdt.device
    dy = dy.to(zxbcdt.dtype).contiguous()
    tiles = -(-l // BWD_ROWS)
    dx = torch.empty(bsz, l, width, dtype=zxbcdt.dtype, device=dev)
    part = torch.empty(bsz * tiles, k + 1, width, dtype=torch.float32, device=dev)
    dwb = torch.empty(k + 1, width, dtype=torch.float32, device=dev)
    body = conv_bwd_body(zxbcdt.dtype, ctot, offset, width, _aligned(zxbcdt, wb, dy, dx, part))
    err = _build.lib().pht_conv_silu_bwd(
        zxbcdt.data_ptr(), wb.data_ptr(), dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
        dwb.data_ptr(), bsz, l, ctot, offset, width, k, BWD_ROWS,
        int(zxbcdt.dtype == torch.bfloat16), int(body == "vec"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, what)
    fused_causal_conv1d_silu_bwd_cuda.launches += 1
    fused_causal_conv1d_silu_bwd_cuda.body_launches[body] += 1
    return dx, dwb[:k].to(w.dtype), dwb[k].to(b.dtype)


fused_causal_conv1d_silu_bwd_cuda.launches = 0
fused_causal_conv1d_silu_bwd_cuda.body_launches = {"vec": 0, "general": 0}
