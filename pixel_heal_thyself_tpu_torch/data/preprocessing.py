"""Host-side EXR preprocessing and importance-sampled patch extraction
(copy of the JAX package's `pixel_heal_thyself_tpu/data/preprocessing.py`).

Behavioral spec: reference `pht/models/afgsa/preprocessing.py` —
- `preprocess_data` (:72-116): GT = 'default' of the high-spp EXR; the
  low-spp EXR provides noisy 'default' + normal/depth/albedo; optional
  box-filter downscale; NaN/Inf → finite; clip radiance ≥0; depth → [0,1];
  aux = concat(normal(3), depth(1), albedo(3)).
- the log-space transforms of the noisy radiance and the normal remap.
- variance / importance maps (:119-168): uniform-filter mean/sq-mean
  variance (optionally relative), channel max, ^(1/2.2), normalized;
  importance = relative-var(noisy) + var(normal).
- dart throwing (:179-213) with progressively shrinking radius (rate 0.96,
  5000 tries) and seeded `random.Random` parity.
- boustrophedon region sweep + error-diffusion pruning (:223-280).
- crop (:325-344): patch_size² crops of {noisy, gt, aux} at sampled centers.

Every function draws from `random.Random` exactly as the JAX package's
does, so a seed gives the same patch positions in both packages. The
sampler runs natively (`native/pht_native.cpp` through the port's own
binding) when g++ can build it, else in Python: the same positions and
the same RNG position either way.
"""

from __future__ import annotations

from random import Random

import numpy as np
from scipy import ndimage

from pixel_heal_thyself_tpu_torch.data.exr import read_exr
from pixel_heal_thyself_tpu_torch.logger import logger

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


# ---------------------------------------------------------------------------
# importance sampling


def get_variance_map(buffer: np.ndarray, patch_size: int, relative: bool = False):
    mean = ndimage.uniform_filter(buffer, size=(patch_size, patch_size, 1))
    sq_mean = ndimage.uniform_filter(buffer**2, size=(patch_size, patch_size, 1))
    variance = np.maximum(sq_mean - mean**2, 0)
    if relative:
        variance = variance / np.maximum(mean**2, 1e-4)
    variance = variance.max(axis=2)
    variance = np.minimum(variance ** (1.0 / 2.2), 1.0)
    return variance / np.maximum(variance.max(), 1e-4)


def get_importance_map(buffers, metrics, weights, patch_size):
    if len(metrics) != len(buffers):
        metrics = [metrics[0]] * len(buffers)
    if len(weights) != len(buffers):
        weights = [weights[0]] * len(buffers)
    importance_map = None
    for buffer, metric, weight in zip(buffers, metrics, weights):
        if metric == "variance":
            temp = get_variance_map(buffer, patch_size, relative=False)
        elif metric == "relative":
            temp = get_variance_map(buffer, patch_size, relative=True)
        else:
            raise ValueError(f"Unknown metric: {metric}")
        importance_map = temp * weight if importance_map is None else importance_map + temp * weight
    return importance_map / np.max(importance_map)


def sample_patches_dart_throwing(
    exr_shape: tuple[int, int],
    patch_size: int,
    num_patches: int,
    rng: Random,
    max_iter: int = 5000,
) -> np.ndarray:
    """Poisson-disk-ish dart throwing with shrinking radius (rate 0.96)."""
    full_area = float(exr_shape[0] * exr_shape[1])
    sample_area = full_area / num_patches
    radius = np.sqrt(sample_area / np.pi)
    min_sq_dist = (2 * radius) ** 2
    rate = 0.96
    patches = np.zeros((num_patches, 2), dtype=int)
    x_min, x_max = 0, exr_shape[1] - patch_size - 1
    y_min, y_max = 0, exr_shape[0] - patch_size - 1
    for i in range(num_patches):
        done = False
        while not done:
            for _ in range(max_iter):
                x = rng.randint(x_min, x_max)
                y = rng.randint(y_min, y_max)
                if i == 0:
                    sq = np.inf
                else:
                    d = patches[:i] - [x, y]
                    sq = np.einsum("ij,ij->i", d, d).min()
                if sq > min_sq_dist:
                    patches[i] = [x, y]
                    done = True
                    break
            if not done:
                radius *= rate
                min_sq_dist = (2 * radius) ** 2
    return patches


def get_region_list(exr_shape: tuple[int, int], step: int):
    """Boustrophedon sweep of step×step regions (x0, x1, y0, y1)."""
    regions = []
    for y in range(0, exr_shape[0], step):
        xr = range(0, exr_shape[1], step)
        if (y // step) % 2 != 0:
            xr = reversed(xr)
        for x in xr:
            regions.append((x, x + step, y, y + step))
    return regions


def split_patches(patches: np.ndarray, region):
    inside = (
        (patches[:, 0] >= region[0])
        & (patches[:, 0] <= region[1])
        & (patches[:, 1] >= region[2])
        & (patches[:, 1] <= region[3])
    )
    return patches[inside], patches[~inside]


def prune_patches(exr_shape, patches: np.ndarray, patch_size: int, imp_map, rng: Random):
    """Error-diffusion pruning against the importance map."""
    pruned = []
    remain = np.copy(patches)
    error = 0.0
    for region in get_region_list(exr_shape, 4 * patch_size):
        current, remain = split_patches(remain, region)
        for x, y in current:
            if imp_map[y, x] - error > rng.random():
                pruned.append((x, y))
                error += 1 - imp_map[y, x]
            else:
                error += 0 - imp_map[y, x]
    return np.array(pruned, dtype=int).reshape(-1, 2)


def importance_sampling(
    data,
    patch_size: int,
    num_patches: int,
    rng: Random,
    use_native: bool = True,
):
    """Padded (x, y) patch centres: dart throwing pruned against the
    importance map, natively when `use_native` and the library builds."""
    buffers = [data["noisy"][:, :, :], data["normal"][:, :, :]]
    h, w = buffers[0].shape[:2]
    if h <= patch_size or w <= patch_size:
        # the dart-throwing x/y ranges collapse: Python's rng.randint
        # raises on an empty range, while the native path would spin or
        # wrap — fail loudly and identically for both
        raise ValueError(
            f"image {w}x{h} is too small for patch_size={patch_size} "
            "importance sampling (needs strictly larger dimensions)",
        )
    imp_map = get_importance_map(
        buffers, ["relative", "variance"], [1.0, 1.0], patch_size,
    )
    if use_native:
        from pixel_heal_thyself_tpu_torch.native import native_importance_sample

        result = native_importance_sample(
            buffers[0].shape[:2], patch_size, num_patches, rng, imp_map,
        )
        if result is not None:
            logger.debug("importance sampling: native path")
            return result
    logger.debug("importance sampling: Python path")
    patches = sample_patches_dart_throwing(
        buffers[0].shape[:2], patch_size, num_patches, rng,
    )
    pad = patch_size // 2
    pruned = np.maximum(
        0,
        prune_patches(buffers[0].shape[:2], patches + pad, patch_size, imp_map, rng)
        - pad,
    )
    return pruned + pad


def crop(data, position, patch_size: int):
    half = patch_size // 2
    px, py = position
    out = {}
    for key, value in data.items():
        if key in ("albedo", "depth", "normal"):
            continue
        out[key] = value[
            py - half : py + half + patch_size % 2,
            px - half : px + half + patch_size % 2,
            :,
        ]
    return out


def get_cropped_patches(exr_path, gt_path, patch_size, num_patches, rng: Random, scale=1.0):
    data = preprocess_data(exr_path, gt_path, scale=scale)
    patches = importance_sampling(data, patch_size, num_patches, rng)
    cropped = [crop(data, tuple(p), patch_size) for p in patches]
    return cropped, patches
