"""Sequence-sharded Mamba full-frame inference.

Port of `pixel_heal_thyself_tpu/parallel/sequence.py`. A frame's rows are
contiguous strips of the global raster-scan token sequence; they are split
over the ranks of a `RowAxis` and the `MambaDenoiserNet` runs on each
strip with `seq_axis` set, where every subcomputation equals the
unsharded model's:

- every padded 2-D convolution exchanges row halos with the neighbouring
  ranks (`ops/padding.make_row_halo_pad`);
- the positional encoding is the global table's slice at the strip's row
  offset;
- the causal conv1d receives the previous rank's last k-1 tokens;
- the SSD chains its [b, h, n, p] state across ranks through per-strip
  affine state summaries (`ops/ssd.ssd_sharded`).

So, unlike the halo-and-crop AFGSA path (`parallel/spatial.py`), this path
is exact for the unbounded receptive field of the global scan, up to
floating-point reordering. Under `seq_axis` each layer takes the literal
chain, as in the JAX package: its megakernel and fused-conv routes have
no carried-in state.
"""

from __future__ import annotations

import torch

from pixel_heal_thyself_tpu_torch.parallel.mesh import RowAxis, row_axis
from pixel_heal_thyself_tpu_torch.parallel.spatial import strip_rows


def make_seq_sharded_apply(model, axis: RowAxis | None = None):
    """Build `apply(noisy, aux) -> out` over whole [B, H, W, C*] frames,
    which every rank holds, for a `MambaDenoiserNet`: this rank's strip of
    rows through `model(..., seq_axis=axis)` (the same module and
    parameters, nothing copied) and the strips of every rank all-gathered.
    H must divide by the ranks. `axis` defaults to `row_axis()`."""
    axis = row_axis() if axis is None else axis

    def apply(noisy: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        rows = strip_rows(noisy.shape[1], axis)
        out = model(noisy[:, rows].contiguous(), aux[:, rows].contiguous(), seq_axis=axis)
        return torch.cat(list(axis.all_gather(out.contiguous())), dim=1)

    return apply
