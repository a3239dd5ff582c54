"""On-device radiance/feature transforms (PyTorch, NHWC).

Port of `pixel_heal_thyself_tpu/ops/transforms.py`: log-transform
`log(x+1)` for noisy/gt radiance and the clipped `(n+1)/2` remap of the
normals (reference `pht/models/afgsa/preprocessing.py:11-48`), run on the
batch's device inside the train and eval steps.
"""

from __future__ import annotations

import torch

EPS_DIFFUSE = 0.00316


def preprocess_specular(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(x)


def postprocess_specular(x: torch.Tensor) -> torch.Tensor:
    return torch.expm1(x)


def preprocess_normal(n: torch.Tensor) -> torch.Tensor:
    return torch.clamp((n + 1.0) * 0.5, 0.0, 1.0)


def preprocess_diffuse(diffuse: torch.Tensor, albedo: torch.Tensor) -> torch.Tensor:
    return diffuse / (albedo + EPS_DIFFUSE)


def postprocess_diffuse(diffuse: torch.Tensor, albedo: torch.Tensor) -> torch.Tensor:
    return diffuse * (albedo + EPS_DIFFUSE)


def prepare_batch(noisy: torch.Tensor, gt: torch.Tensor, aux: torch.Tensor,
                  log_gt: bool = True):
    """Batch prep (NHWC): normals remapped, radiance log-mapped.
    `log_gt=False` keeps gt linear, as validation does (reference
    `base_trainer.py:536-545`)."""
    aux = torch.cat([preprocess_normal(aux[..., :3]), aux[..., 3:]], dim=-1)
    noisy = preprocess_specular(noisy)
    if log_gt:
        gt = preprocess_specular(gt)
    return noisy, gt, aux
