"""Image conversion and the validation panels.

Port of `pixel_heal_thyself_tpu/utils/images.py` (behavioural spec:
reference `pht/models/afgsa/util.py:77-211`): tone mapping (gamma 1/2.2),
float → uint8 image with optional specular/diffuse post-processing, the
1×3 Noisy / Output / Reference validation panel, and mkdir-with-suffix.
Arrays are HWC / NHWC.

The panel is the three images side by side, written as an 8-bit RGB PNG
by a small numpy + `zlib` writer (`write_png`): the port needs no
matplotlib, so the panel carries no titles.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from pixel_heal_thyself_tpu_torch.data.preprocessing import (
    postprocess_diffuse,
    postprocess_specular,
)


def tone_mapping(matrix: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    # negatives clamp to 0 *before* the fractional power (the reference,
    # `util.py:73-74`, powered first and made NaNs of negative radiance)
    return np.clip(np.maximum(matrix, 0.0) ** (1.0 / gamma), 0, 1)


def tensor2img(
    image_numpy: np.ndarray,
    post_spec: bool = False,
    post_diff: bool = False,
    albedo: np.ndarray | None = None,
) -> np.ndarray:
    """HWC (or NHWC) float → tone-mapped uint8 [0,255]."""
    if post_diff and albedo is None:
        raise ValueError("must provide albedo when post_diff is True")
    if image_numpy.ndim == 4:
        return np.array(
            [
                tensor2img(
                    im,
                    post_spec=post_spec and not post_diff,
                    post_diff=post_diff,
                    albedo=albedo[i] if post_diff else None,
                )
                for i, im in enumerate(image_numpy)
            ],
        )
    img = np.asarray(image_numpy, np.float64)
    if post_spec:
        img = postprocess_specular(img)
    elif post_diff:
        img = postprocess_diffuse(img, albedo)
    img = tone_mapping(img) * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 image as an 8-bit RGB PNG (no filtering)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def save_img_group(
    save_path: str,
    index: int,
    noisy: np.ndarray,
    output: np.ndarray,
    y: np.ndarray,
) -> None:
    """`<index>.png`: the Noisy | Output | Reference panel, untitled."""
    if noisy.ndim == 4:
        noisy, output, y = noisy[0], output[0], y[0]
    write_png(os.path.join(save_path, f"{index}.png"), np.concatenate([noisy, output, y], axis=1))


def create_folder(path: str, still_create: bool = False) -> str:
    """mkdir; with `still_create`, append _N until a fresh name is found."""
    if not os.path.exists(path):
        os.makedirs(path)
        return path
    if still_create:
        count = 1
        while True:
            candidate = f"{path}_{count}"
            if not os.path.exists(candidate):
                os.makedirs(candidate)
                return candidate
            count += 1
    return path
