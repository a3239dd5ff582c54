"""Spatial padding of NHWC tensors with torch Conv2d padding_mode semantics.

Port of `pixel_heal_thyself_tpu/ops/padding.py:31` (`pad2d`). The JAX
package pads explicitly and runs VALID convolutions; the port does the
same so both packages see identical padded inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_TORCH_MODES = {"zeros": "constant", "reflect": "reflect", "replicate": "replicate"}


def pad2d(x: torch.Tensor, pad: int, mode: str = "zeros") -> torch.Tensor:
    """Pad H and W of an NHWC tensor by `pad` on each side.

    `mode` is one of torch Conv2d's `zeros`, `reflect`, `replicate`."""
    tmode = _TORCH_MODES.get(mode)
    if tmode is None:
        raise ValueError(f"unknown padding mode {mode!r}")
    if pad == 0:
        return x
    # F.pad pads trailing dims; NHWC → NCHW so it pads H and W
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode=tmode)
    return y.permute(0, 2, 3, 1).contiguous()
