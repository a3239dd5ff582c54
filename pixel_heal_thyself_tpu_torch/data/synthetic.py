"""Synthetic volumetric-render scene generator for CI/tests/benchmarks.

The reference trains on fftle/taccturb volumetric path-traced EXR pairs,
which are not distributed with it, so the framework ships a generator producing structurally-similar pairs: smooth
HDR "radiance" fields with Monte-Carlo-style noise scaled by 1/sqrt(spp),
plus normal/depth/albedo aux buffers, written as
`<scene>_<idx>_<spp>.exr` under `{32spp,1024spp}` directories — the layout
`Hdf5Constructor` expects (reference `gen_hdf5.py:54-85`).

Copy of the JAX package's `pixel_heal_thyself_tpu/data/synthetic.py`, so that the
port imports nothing of that package; tests/test_torch_port_host.py
holds the two equal.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pixel_heal_thyself_tpu_torch.data.exr import write_exr_groups


def _smooth_field(rng: np.random.Generator, h: int, w: int, c: int, octaves: int = 4):
    """Multi-octave smooth random field in [0, 1]."""
    out = np.zeros((h, w, c), np.float32)
    amp = 1.0
    for o in range(octaves):
        gh = max(2, h >> (octaves - o))
        gw = max(2, w >> (octaves - o))
        grid = rng.standard_normal((gh, gw, c)).astype(np.float32)
        # bilinear upsample to full res
        yi = np.linspace(0, gh - 1, h)
        xi = np.linspace(0, gw - 1, w)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, gh - 1)
        x1 = np.minimum(x0 + 1, gw - 1)
        wy = (yi - y0)[:, None, None]
        wx = (xi - x0)[None, :, None]
        up = (
            grid[y0][:, x0] * (1 - wy) * (1 - wx)
            + grid[y0][:, x1] * (1 - wy) * wx
            + grid[y1][:, x0] * wy * (1 - wx)
            + grid[y1][:, x1] * wy * wx
        )
        out += amp * up
        amp *= 0.5
    out -= out.min()
    out /= max(out.max(), 1e-6)
    return out


def generate_scene(
    rng: np.random.Generator,
    height: int = 128,
    width: int = 128,
    hdr_scale: float = 4.0,
    noisy_spp: int = 32,
    gt_spp: int = 1024,
    noise_scale: float = 3.0,
):
    """One scene: returns (gt_groups, noisy_groups) channel dicts.

    `noise_scale` is the relative-MC-noise coefficient (std of the noisy
    channel = `noise_scale / sqrt(spp)` of the radiance). 3.0 is the
    historic "very noisy 32spp" default; lower values model cleaner
    renders — the quality-band validation knob
    (`data.images.synthetic_noise`, VERDICT r3 #4)."""
    radiance = _smooth_field(rng, height, width, 3) ** 2 * hdr_scale
    albedo = np.clip(_smooth_field(rng, height, width, 3), 0.05, 1.0)
    depth = _smooth_field(rng, height, width, 1) * 10.0
    normal = _smooth_field(rng, height, width, 3) * 2.0 - 1.0
    normal /= np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-6)

    def render(spp: int):
        # MC noise: relative, heavier in bright regions, ~1/sqrt(spp)
        noise = rng.standard_normal(radiance.shape).astype(np.float32)
        noisy = radiance * (1.0 + noise * (noise_scale / np.sqrt(spp)))
        return np.clip(noisy, 0.0, None).astype(np.float32)

    gt_groups = {"default": render(gt_spp)}
    noisy_groups = {
        "default": render(noisy_spp),
        "normal": normal.astype(np.float32),
        "depth": depth.astype(np.float32),
        "albedo": albedo.astype(np.float32),
    }
    return gt_groups, noisy_groups


def generate_dataset(
    images_dir: str | Path,
    scenes: list[str] | None = None,
    height: int = 128,
    width: int = 128,
    noisy_spp: int = 32,
    gt_spp: int = 1024,
    noise_scale: float = 3.0,
    seed: int = 0,
) -> None:
    """Write a full synthetic dataset tree under `images_dir`."""
    scenes = scenes or ["fftle0_0", "fftle1_0", "taccturb0_0", "taccturb1_0"]
    images_dir = Path(images_dir)
    noisy_dir = images_dir / f"{noisy_spp}spp"
    gt_dir = images_dir / f"{gt_spp}spp"
    noisy_dir.mkdir(parents=True, exist_ok=True)
    gt_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for scene in scenes:
        gt_groups, noisy_groups = generate_scene(
            rng, height, width, noisy_spp=noisy_spp, gt_spp=gt_spp,
            noise_scale=noise_scale,
        )
        write_exr_groups(
            gt_dir / f"{scene}_{gt_spp}.exr", gt_groups, pixel_type="float",
        )
        write_exr_groups(
            noisy_dir / f"{scene}_{noisy_spp}.exr", noisy_groups, pixel_type="float",
        )
