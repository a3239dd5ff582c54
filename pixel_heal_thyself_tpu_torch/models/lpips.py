"""LPIPS perceptual distance on a VGG16 backbone (PyTorch, NHWC in).

Port of `pixel_heal_thyself_tpu/models/lpips.py` (Zhang et al. 2018; the
reference used the `lpips` package with pretrained VGG16 weights,
`pht/models/base_trainer.py:144-148,439-449`): the 13 VGG16 3×3 convs with
ReLU and four 2×2 max-pools, taps after relu1_2, relu2_2, relu3_3, relu4_3
and relu5_3; each tap unit-normalised over channels, the squared
difference weighted by the 1×1 `lin` head, summed over channels,
averaged over space and summed over taps.

Weights come from an `.npz` in the layout `tools/convert_lpips_weights.py`
writes (`features.<i>.weight` OIHW, `features.<i>.bias`, `lin<k>.weight`
[1, C, 1, 1]) or, for tests and ablations, from `random_lpips_params`,
whose numpy draws are the JAX package's bit for bit. The params are a dict
`{"convs": [(weight OIHW, bias), …13], "lins": [[C], …5]}` of float32
tensors; `params.lpips_params_from_jax` carries a JAX LPIPS tree (HWIO)
across. The convs run in NCHW through library PyTorch (plain XLA in the
JAX package).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from pixel_heal_thyself_tpu_torch.parallel.data import global_max

# torchvision VGG16 conv layer indices and channels
_VGG16_CONVS = [
    (0, 64), (2, 64),
    (5, 128), (7, 128),
    (10, 256), (12, 256), (14, 256),
    (17, 512), (19, 512), (21, 512),
    (24, 512), (26, 512), (28, 512),
]
_POOL_BEFORE = {5, 10, 17, 24}  # a max-pool precedes these conv indices
_TAP_AFTER = {3: 0, 8: 1, 15: 2, 22: 3, 29: 4}  # relu index → tap slot
_TAP_CHANNELS = [64, 128, 256, 512, 512]

# the LPIPS input normalisation (its 'scaling layer'), per RGB channel
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def lpips_params_to(params: dict, device) -> dict:
    """`params` with every tensor on `device`."""
    return {"convs": [(w.to(device), b.to(device)) for w, b in params["convs"]],
            "lins": [lin.to(device) for lin in params["lins"]]}


def load_lpips_params(path: str | Path, device=None) -> dict:
    """Converted weights (`tools/convert_lpips_weights.py`'s npz) as the
    port's params, on `device` (the CPU when None)."""
    with np.load(str(path)) as raw:
        params = {
            "convs": [(_tensor(raw[f"features.{i}.weight"]), _tensor(raw[f"features.{i}.bias"]))
                      for i, _ in _VGG16_CONVS],
            "lins": [_tensor(raw[f"lin{k}.weight"].reshape(-1)) for k in range(5)],
        }
    return params if device is None else lpips_params_to(params, device)


def random_lpips_params(seed: int = 0, device=None) -> dict:
    """Random-weight LPIPS (tests, ablation without pretrained data): the
    JAX package's numpy draws in its order, the kernels HWIO → OIHW."""
    rng = np.random.default_rng(seed)
    params: dict = {"convs": [], "lins": []}
    in_ch = 3
    for _, out_ch in _VGG16_CONVS:
        w = rng.standard_normal((3, 3, in_ch, out_ch)).astype(np.float32)
        w *= np.sqrt(2.0 / (9 * in_ch))
        params["convs"].append((_tensor(w.transpose(3, 2, 0, 1)), torch.zeros(out_ch)))
        in_ch = out_ch
    for c in _TAP_CHANNELS:
        params["lins"].append(_tensor(rng.uniform(0, 1, c).astype(np.float32)))
    return params if device is None else lpips_params_to(params, device)


def _vgg_features(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """NHWC `x` in [-1, 1] → the 5 tapped ReLU feature maps, NCHW."""
    shift = torch.as_tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    x = (x.permute(0, 3, 1, 2) - shift) / scale
    taps: list = [None] * 5
    for (conv_idx, _), (w, b) in zip(_VGG16_CONVS, params["convs"]):
        if conv_idx in _POOL_BEFORE:
            x = F.max_pool2d(x, 2)
        x = F.relu(F.conv2d(x, w.to(x.dtype), b.to(x.dtype), padding=1))
        if conv_idx + 1 in _TAP_AFTER:
            taps[_TAP_AFTER[conv_idx + 1]] = x
    return taps


def lpips_distance(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample LPIPS distance [B] of NHWC images in [-1, 1]."""
    total = 0.0
    for fx, fy, lin in zip(_vgg_features(params, x), _vgg_features(params, y), params["lins"]):
        a = fx / torch.clamp(torch.linalg.vector_norm(fx, dim=1, keepdim=True), min=1e-10)
        b = fy / torch.clamp(torch.linalg.vector_norm(fy, dim=1, keepdim=True), min=1e-10)
        d = (a - b) ** 2
        total = total + torch.sum(d * lin.to(d.dtype).view(1, -1, 1, 1), dim=1).mean(dim=(1, 2))
    return total


def to_lpips_range(x_log: torch.Tensor, group=None) -> torch.Tensor:
    """Log-radiance → [-1, 1] (reference `base_trainer.py:441-444`),
    normalised by the max over the whole batch: over every rank's rows
    with a data `group` (`parallel.data.global_max`). The clip is
    jnp.clip's max-then-min, whose gradient halves at a bound (an output
    pixel of exactly 0), where `torch.clamp` would pass it whole."""
    x_lin = torch.expm1(x_log)
    zero, one = x_lin.new_zeros(()), x_lin.new_ones(())
    x_rgb = torch.minimum(torch.maximum(x_lin / (global_max(x_lin, group) + 1e-6), zero), one)
    return x_rgb * 2.0 - 1.0
