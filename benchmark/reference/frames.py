"""Plain reference of a served frame: the host transforms and the tiler.

A frame [H, W, 3] of noisy linear radiance with its aux buffers [H, W, C]
(normals in [−1, 1] first) is log-mapped (log(x + 1)), its normals remapped
to (n + 1)/2 clipped to [0, 1], edge-padded by `margin`, cut into
(tile + 2·margin)² windows at stride `tile`, denoised a batch of windows at
a time, each window's centre tile kept and written into the frame, and
mapped back to linear radiance (exp(y) − 1).
"""

from __future__ import annotations

import torch

from benchmark.reference.nn import Arith


@torch.no_grad()
def denoise_frame(model, noisy: torch.Tensor, aux: torch.Tensor, *, tile: int, margin: int,
                  batch: int, arith: Arith) -> torch.Tensor:
    """The reference's linear frame [H, W, 3] (float32, on `noisy`'s device)."""
    h, w, _ = noisy.shape
    x = torch.log1p(noisy.float())
    a = aux.float().clone()
    a[..., :3] = ((torch.nan_to_num(a[..., :3]) + 1.0) * 0.5).clamp(0.0, 1.0)
    ht, wt = -(-h // tile), -(-w // tile)
    rows = torch.arange(-margin, ht * tile + margin, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-margin, wt * tile + margin, device=x.device).clamp(0, w - 1)
    xp, ap = x[rows][:, cols], a[rows][:, cols]
    size = tile + 2 * margin
    corners = [(ty * tile, tx * tile) for ty in range(ht) for tx in range(wt)]
    out = torch.empty(ht * tile, wt * tile, x.shape[-1], device=x.device)
    for i in range(0, len(corners), batch):
        part = corners[i:i + batch]
        xs = torch.stack([xp[y:y + size, c:c + size] for y, c in part])
        as_ = torch.stack([ap[y:y + size, c:c + size] for y, c in part])
        ys = model(xs, as_, arith)[:, margin:margin + tile, margin:margin + tile]
        for (y, c), t in zip(part, ys):
            out[y:y + tile, c:c + tile] = t
    return torch.expm1(out[:h, :w])
