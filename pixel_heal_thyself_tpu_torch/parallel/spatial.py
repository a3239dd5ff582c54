"""Row-sharded full-frame inference with halo exchange (AFGSA).

Port of `pixel_heal_thyself_tpu/parallel/spatial.py`. The frame's rows
are split over the ranks of a `RowAxis`; each rank takes `margin` halo
rows from each neighbour (`RowAxis.exchange`, JAX's `lax.ppermute`),
replicates the frame's edge row at the top and bottom of the frame (the
`np.pad(mode="edge")` of the tiled path, so both full-frame paths agree at
the borders), runs the model on its strip and halos, crops the halos and
all-gathers the strips. Exact wherever `margin` covers the model's
receptive reach, which attention's bounded windows make finite.
"""

from __future__ import annotations

import torch

from pixel_heal_thyself_tpu_torch.parallel.mesh import RowAxis, row_axis


def strip_rows(h: int, axis: RowAxis) -> slice:
    """This rank's rows of an H-row frame; raises unless the ranks divide H."""
    if h % axis.size:
        raise ValueError(f"H={h} not divisible by the row axis' {axis.size} ranks")
    strip = h // axis.size
    return slice(axis.index * strip, (axis.index + 1) * strip)


def make_sharded_apply_rows(apply_fn, margin: int, axis: RowAxis | None = None):
    """Build `apply(noisy, aux) -> out` over whole [B, H, W, C*] frames,
    which every rank holds: this rank's strip of rows with `margin` halo
    rows on each side through `apply_fn(noisy, aux)`, cropped, and the
    strips of every rank all-gathered (see the module docstring). `axis`
    defaults to `row_axis()`."""
    axis = row_axis() if axis is None else axis
    if margin < 1:
        raise ValueError(
            f"margin={margin} must be >= 1: the halo exchange ships `margin` edge rows "
            "per neighbour (and x[:, -margin:] would select the whole strip at 0)",
        )

    def exchange_halo(x: torch.Tensor) -> torch.Tensor:
        from_up, from_down = axis.exchange(x[:, -margin:], x[:, :margin])
        if from_up is None:  # the frame's top: its edge row, replicated
            from_up = x[:, :1].expand(-1, margin, -1, -1)
        if from_down is None:
            from_down = x[:, -1:].expand(-1, margin, -1, -1)
        return torch.cat([from_up, x, from_down], dim=1)

    def apply(noisy: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        rows = strip_rows(noisy.shape[1], axis)
        out = apply_fn(exchange_halo(noisy[:, rows]), exchange_halo(aux[:, rows]))
        out = out[:, margin:-margin].contiguous()
        return torch.cat(list(axis.all_gather(out)), dim=1)

    return apply


def sharded_apply_rows(apply_fn, margin: int, noisy: torch.Tensor, aux: torch.Tensor,
                       axis: RowAxis | None = None) -> torch.Tensor:
    """One frame through `make_sharded_apply_rows(apply_fn, margin, axis)`.
    noisy/aux: [B, H, W, C*], H divisible by the ranks; each strip plus
    2·margin rows must meet the model's divisibility (margin a multiple of
    the attention block). Loops over frames build the callable once."""
    return make_sharded_apply_rows(apply_fn, margin, axis)(noisy, aux)
