"""Host-side EXR preprocessing (copy of the JAX package's
`pixel_heal_thyself_tpu/data/preprocessing.py`, serving part).

Behavioral spec: reference `pht/models/afgsa/preprocessing.py` —
- `preprocess_data` (:72-116): GT = 'default' of the high-spp EXR; the
  low-spp EXR provides noisy 'default' + normal/depth/albedo; optional
  box-filter downscale; NaN/Inf → finite; clip radiance ≥0; depth → [0,1];
  aux = concat(normal(3), depth(1), albedo(3)).
- the log-space transforms of the noisy radiance and the normal remap.

Importance-sampled patch extraction (dataset construction for training)
is not copied yet: it comes with the port's trainer.
"""

from __future__ import annotations

import numpy as np

from pixel_heal_thyself_tpu_torch.data.exr import read_exr

eps = 0.00316


def preprocess_diffuse(diffuse, albedo):
    return diffuse / (albedo + eps)


def preprocess_specular(specular):
    return np.log(specular + 1)


def preprocess_depth(depth):
    depth = np.clip(depth, 0.0, np.max(depth))
    max_feature = np.max(depth)
    if max_feature != 0:
        depth = depth / max_feature
    return depth


def preprocess_normal(normal):
    normal = np.nan_to_num(normal)
    normal = (normal + 1.0) * 0.5
    return np.clip(normal, 0.0, 1.0)


def postprocess_diffuse(diffuse, albedo):
    return diffuse * (albedo + eps)


def postprocess_specular(specular):
    return np.exp(specular) - 1


def scale_exr_img(exr_data: dict[str, np.ndarray], scale: float = 0.5):
    """Box-filter downscale every channel by 1/scale (must divide dims)."""
    scaled = {}
    for name, chan in exr_data.items():
        h, w, c = chan.shape
        block = int(1 / scale)
        if h % block or w % block:
            raise ValueError(f"image dims ({h}x{w}) must be divisible by {block}")
        scaled[name] = chan.reshape(h // block, block, w // block, block, c).mean(
            axis=(1, 3),
        )
    return scaled


def preprocess_data(exr_path: str, gt_path: str, scale: float = 1.0):
    """Load a noisy/GT EXR pair into the training buffer dict."""
    data = {}
    gt = read_exr(str(gt_path) + ".exr")
    data["gt"] = gt["default"]

    noisy = read_exr(str(exr_path) + ".exr")
    for key, src in (("normal", "normal"), ("depth", "depth"), ("albedo", "albedo"), ("noisy", "default")):
        data[key] = noisy[src]

    if scale != 1.0:
        data = scale_exr_img(data, scale=scale)

    for name, value in data.items():
        data[name] = np.nan_to_num(value)

    data["gt"] = np.clip(data["gt"], 0, np.max(data["gt"]))
    data["noisy"] = np.clip(data["noisy"], 0, np.max(data["noisy"]))
    data["depth"] = preprocess_depth(data["depth"].copy())

    data["aux"] = np.concatenate(
        (data["normal"].copy(), data["depth"].copy(), data["albedo"].copy()),
        axis=2,
    )
    return data
