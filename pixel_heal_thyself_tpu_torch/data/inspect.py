"""EXR channel inspection & display helpers (PyTorch port).

Port of `pixel_heal_thyself_tpu/data/inspect.py` (behavioural spec:
reference `pht/models/afgsa/util.py:17-68`): describe an EXR's
geometry/channels, and render a single channel with per-channel display
normalization: radiance-like channels are clipped to [0,1] and gamma-mapped
(exponent 0.45454545), normals are unit-normalized and absolute-valued,
depth-like scalars are max-normalized.

Where the JAX module draws the channel with matplotlib (a saved figure, or
`plt.show()` without a path), this one needs no matplotlib, which the GPU
machines lack: `show_exr_channel(save_path=...)` writes the normalized
channel itself as an 8-bit RGB PNG through `utils.images.write_png` (a
one-channel array repeated to RGB, values quantized as `tensor2img`
quantizes: ×255, clipped to [0, 255], truncated to uint8), with no title
or axes; without `save_path` it logs the stats and returns the array, as
there is no window to show it in.

    python -m pixel_heal_thyself_tpu_torch.data.inspect FILE [CHANNEL] [--save PNG]
"""

from __future__ import annotations

import numpy as np

from pixel_heal_thyself_tpu_torch.data.exr import (
    _PIXEL_TYPES,
    _group_key,
    read_exr,
    read_exr_header,
)
from pixel_heal_thyself_tpu_torch.logger import logger

_GAMMA_CHANNELS = {"default", "target", "diffuse", "albedo", "specular"}
_NORMAL_CHANNELS = {"normal", "normalA"}
_MAXNORM_CHANNELS = {"depth", "visibility", "normalVariance"}

_COMPRESSION_NAMES = {0: "none", 1: "rle", 2: "zips", 3: "zip", 4: "piz"}


def process_channel_display(data: np.ndarray, channel: str) -> np.ndarray:
    """Per-channel display normalization (reference `util.py:28-45`)."""
    data = np.asarray(data, np.float32).copy()
    if channel in _GAMMA_CHANNELS:
        data = np.clip(data, 0, 1) ** 0.45454545
    elif channel in _NORMAL_CHANNELS:
        norm = np.linalg.norm(data, axis=-1, keepdims=True)
        data = np.abs(data / np.where(norm == 0, 1.0, norm))
    elif channel in _MAXNORM_CHANNELS and np.max(data) != 0:
        data = data / np.max(data)
    if data.ndim == 3 and data.shape[2] == 1:
        data = data.reshape(data.shape[0], data.shape[1])
    return data


def describe_exr(exr_path: str) -> str:
    """Human-readable summary of an EXR's header (pyexr.describe_channels
    analog used by reference `util.py:48-57`)."""
    hdr = read_exr_header(exr_path)
    lines = [
        f"Width: {hdr['width']}",
        f"Height: {hdr['height']}",
        f"Compression: {_COMPRESSION_NAMES.get(hdr['compression'], hdr['compression'])}",
        "Available channels:",
    ]
    for name, ptype in hdr["channels"]:
        tname = np.dtype(_PIXEL_TYPES[ptype]).name if ptype in _PIXEL_TYPES else "?"
        lines.append(f"  {name:<20} {tname}")
    # the group count from the header alone (read_exr's grouping): describing
    # a frame must not decompress its whole payload
    n_default = sum(1 for name, _ in hdr["channels"] if _group_key(name)[0] == "default")
    if n_default:
        lines.append(f"Default channels: {n_default}")
    return "\n".join(lines)


def show_exr_info(exr_path: str) -> None:
    """Log the EXR header summary (reference `util.py:48-57`)."""
    if not exr_path:
        raise ValueError("exr_path cannot be empty")
    if not exr_path.endswith("exr"):
        raise ValueError("img to be shown must be in '.exr' format")
    logger.info(describe_exr(exr_path))


def display_image(disp: np.ndarray) -> np.ndarray:
    """A display-normalized channel as the [H, W, 3] uint8 image
    `show_exr_channel` saves: one channel repeated to RGB, two padded with
    a zero blue, more than three cut to the first three."""
    if disp.ndim == 2:
        disp = disp[..., None]
    if disp.shape[-1] == 1:
        disp = np.repeat(disp, 3, axis=-1)
    elif disp.shape[-1] == 2:
        disp = np.concatenate([disp, np.zeros_like(disp[..., :1])], axis=-1)
    return np.clip(disp[..., :3] * 255.0, 0, 255).astype(np.uint8)


def show_exr_channel(
    exr_path: str,
    channel: str,
    save_path: str | None = None,
) -> np.ndarray:
    """Render one channel group with display normalization (reference
    `util.py:60-68`); returns the normalized array. Writes it as a PNG
    (`display_image`) when `save_path` is given."""
    from pixel_heal_thyself_tpu_torch.utils.images import write_png

    groups = read_exr(exr_path)
    if channel not in groups:
        raise KeyError(f"channel {channel!r} not in {sorted(groups)} of {exr_path}")
    data = groups[channel]
    logger.info(f"Channel: {channel}")
    logger.info(f"Shape: {data.shape}")
    logger.info(f"Max: {np.max(data):f}    Min: {np.min(data):f}")
    disp = process_channel_display(data, channel)
    if save_path is not None:
        write_png(save_path, display_image(disp))
    return disp


def main(argv=None) -> None:
    """CLI: python -m pixel_heal_thyself_tpu_torch.data.inspect FILE [CHANNEL]"""
    import argparse

    ap = argparse.ArgumentParser(prog="exr-inspect")
    ap.add_argument("exr_path")
    ap.add_argument("channel", nargs="?")
    ap.add_argument("--save", help="PNG output path for channel display")
    args = ap.parse_args(argv)
    print(describe_exr(args.exr_path))
    if args.channel:
        show_exr_channel(args.exr_path, args.channel, save_path=args.save)


if __name__ == "__main__":
    main()
