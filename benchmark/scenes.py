"""Synthetic render buffers, made on the device from a seed.

The arithmetic of the program's synthetic scene generator
(`data/synthetic.generate_scene`), batched over scenes in a few large
calls on the device instead of written to EXR files: multi-octave smooth
random fields (bilinear upsampling of normal grids, 4 octaves, each half
the last's amplitude, normalised to [0, 1]); radiance = field² · hdr_scale;
albedo clipped to [0.05, 1]; depth = field · 10, then divided by its
maximum as the frame reader does; unit normals from a field mapped to
[−1, 1]; a render at `spp` samples = radiance · (1 + N(0, 1) ·
noise_scale / √spp), clipped at 0. Aux = normals, depth, albedo (7
channels), in the reader's order.
"""

from __future__ import annotations

import torch


def smooth_fields(gen: torch.Generator, n: int, h: int, w: int, c: int, device,
                  octaves: int = 4) -> torch.Tensor:
    """[n, h, w, c] smooth fields in [0, 1], each (scene, channel-set) normalised
    over its own pixels and channels."""
    out = torch.zeros(n, h, w, c, device=device)
    amp = 1.0
    for o in range(octaves):
        gh, gw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        grid = torch.randn(n, gh, gw, c, generator=gen, device=device)
        yi = torch.linspace(0, gh - 1, h, device=device, dtype=torch.float64)
        xi = torch.linspace(0, gw - 1, w, device=device, dtype=torch.float64)
        y0, x0 = yi.floor().long(), xi.floor().long()
        y1, x1 = (y0 + 1).clamp(max=gh - 1), (x0 + 1).clamp(max=gw - 1)
        wy = (yi - y0).float()[None, :, None, None]
        wx = (xi - x0).float()[None, None, :, None]
        g0, g1 = grid[:, y0], grid[:, y1]
        up = ((g0[:, :, x0] * (1 - wx) + g0[:, :, x1] * wx) * (1 - wy)
              + (g1[:, :, x0] * (1 - wx) + g1[:, :, x1] * wx) * wy)
        out += amp * up
        amp *= 0.5
    flat = out.reshape(n, -1)
    lo = flat.min(dim=1).values[:, None, None, None]
    out = out - lo
    hi = out.reshape(n, -1).max(dim=1).values.clamp_min(1e-6)[:, None, None, None]
    return out / hi


def scenes(gen: torch.Generator, n: int, h: int, w: int, device, *, spp: int,
           gt_spp: int | None, noise_scale: float, hdr_scale: float) -> dict:
    """{"noisy" [n,h,w,3], "aux" [n,h,w,7] (and "gt" at `gt_spp`)} float32 on
    `device`."""
    radiance = smooth_fields(gen, n, h, w, 3, device) ** 2 * hdr_scale
    albedo = smooth_fields(gen, n, h, w, 3, device).clamp(0.05, 1.0)
    depth = smooth_fields(gen, n, h, w, 1, device) * 10.0
    normal = smooth_fields(gen, n, h, w, 3, device) * 2.0 - 1.0
    normal = normal / normal.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    depth = depth / depth.reshape(n, -1).max(dim=1).values.clamp_min(1e-12)[:, None, None, None]

    def render(s: int) -> torch.Tensor:
        noise = torch.randn(radiance.shape, generator=gen, device=device)
        return (radiance * (1.0 + noise * (noise_scale / s ** 0.5))).clamp_min(0.0)

    out = {"noisy": render(spp), "aux": torch.cat([normal, depth, albedo], dim=-1)}
    if gt_spp is not None:
        out["gt"] = render(gt_spp)
    return out
