"""Spatial padding of NHWC tensors with torch Conv2d padding_mode semantics.

Port of `pixel_heal_thyself_tpu/ops/padding.py`: `pad2d` (:31) and
`make_row_halo_pad` (:38), the drop-in that pads a row-sharded strip with
its neighbouring ranks' rows. The JAX package pads explicitly and runs
VALID convolutions; the port does the same so both packages see identical
padded inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_TORCH_MODES = {"zeros": "constant", "reflect": "reflect", "replicate": "replicate"}


def _torch_mode(mode: str) -> str:
    tmode = _TORCH_MODES.get(mode)
    if tmode is None:
        raise ValueError(f"unknown padding mode {mode!r}")
    return tmode


def _edges(x: torch.Tensor, dim: int, lo: int, hi: int, tmode: str) -> torch.Tensor:
    """`x` padded along `dim` by `lo` and `hi` with copies of its own
    rows: mirrored without the edge (reflect) or the edge repeated."""
    if not (lo or hi):
        return x
    n = x.shape[dim]
    if tmode == "reflect":
        parts = [x.narrow(dim, 1, lo).flip(dim), x, x.narrow(dim, n - 1 - hi, hi).flip(dim)]
    else:
        def edge(i: int, k: int) -> torch.Tensor:
            shape = list(x.shape)
            shape[dim] = k
            return x.narrow(dim, i, 1).expand(shape)

        parts = [edge(0, lo), x, edge(n - 1, hi)]
    return torch.cat(parts, dim)


def _pad(x: torch.Tensor, widths: tuple, tmode: str) -> torch.Tensor:
    """F.pad of an NHWC tensor by (w_lo, w_hi, h_lo, h_hi). Where a
    gradient flows back through reflect or replicate padding, the same
    values come from slices and concatenations instead: F.pad's CUDA
    backward for those modes sums the border into the input with atomics,
    in an order that changes from run to run, and autograd sums the
    copies' gradients in one fixed order."""
    if tmode != "constant" and torch.is_grad_enabled() and x.requires_grad:
        w_lo, w_hi, h_lo, h_hi = widths
        return _edges(_edges(x, 2, w_lo, w_hi, tmode), 1, h_lo, h_hi, tmode)
    # F.pad pads trailing dims; NHWC → NCHW so it pads H and W
    return F.pad(x.permute(0, 3, 1, 2), widths, mode=tmode).permute(0, 2, 3, 1)


def pad2d(x: torch.Tensor, pad: int, mode: str = "zeros") -> torch.Tensor:
    """Pad H and W of an NHWC tensor by `pad` on each side.

    `mode` is one of torch Conv2d's `zeros`, `reflect`, `replicate`."""
    tmode = _torch_mode(mode)
    if pad == 0:
        return x
    return _pad(x, (pad, pad, pad, pad), tmode).contiguous()


def make_row_halo_pad(axis):
    """A `(x, pad, mode) -> padded` drop-in for `pad2d` on a strip of rows
    of a frame sharded contiguously over the ranks of `axis` (a
    `parallel.mesh.RowAxis`): H is padded with the neighbouring ranks' edge
    rows instead of a local reflect/replicate, so a row-sharded
    convolution computes exactly what the unsharded one would. W is padded
    first, so the exchanged rows carry their W padding; the first and last
    rank keep the local pad at the frame's top and bottom (their local
    rows are the frame's boundary rows, exact for pad < strip height).
    With one rank it is `pad2d`. Every rank must call it with the same
    pad: it is a collective."""

    def pad_fn(x: torch.Tensor, pad: int, mode: str = "zeros") -> torch.Tensor:
        if pad == 0:
            return x
        if axis.size == 1:
            return pad2d(x, pad, mode)
        tmode = _torch_mode(mode)
        xw = _pad(x, (pad, pad, 0, 0), tmode)
        top, bot = axis.exchange(xw[:, -pad:], xw[:, :pad])
        if top is None or bot is None:
            local = _pad(xw, (0, 0, pad, pad), tmode)
            top = local[:, :pad] if top is None else top
            bot = local[:, -pad:] if bot is None else bot
        return torch.cat([top, xw, bot], dim=1)

    return pad_fn
