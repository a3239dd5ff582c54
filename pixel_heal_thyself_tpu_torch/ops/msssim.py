"""Multi-scale SSIM (PyTorch, NHWC).

Port of `pixel_heal_thyself_tpu/ops/msssim.py`:
- `ms_ssim` / `ms_ssim_loss`: Wang et al. MS-SSIM, an 11×11 Gaussian
  window (σ 1.5) applied VALID, 2×2 average pooling between scales, the
  scale count clamped so the window fits and the canonical weights
  renormalised over the scales used;
- `ms_ssim_mix_loss`: kornia's `MS_SSIMLoss(reduction='mean')` analogue,
  the loss the reference's SSIMLoss wraps: SSIM at five Gaussian scales
  (σ 0.5 … 8) at full resolution through 33×33 zero-padded windows, the
  contrast-structure terms multiplied over scales and channels, the
  luminance of the coarsest scale, alpha-mixed with a Gaussian-weighted L1
  and multiplied by the compensation 200.

Each Gaussian window is the outer product of a normalised 1-D Gaussian, so
its depthwise filter runs as two 1-D passes (`F.conv2d` with `groups`):
the same function as the JAX package's 2-D window (zero padding pads each
pass alike), 33 + 33 taps instead of 33 × 33; the sums differ from the
2-D window's only in float32 rounding. Depthwise filtering is plain XLA in
the JAX package: library PyTorch here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])
_WINDOW, _SIGMA = 11, 1.5  # Wang et al.'s window
# kornia's MS_SSIMLoss defaults: its sigmas, (k1, k2), alpha, compensation;
# the data range is 1
_KORNIA_SIGMAS = (0.5, 1.0, 2.0, 4.0, 8.0)
_K, _ALPHA, _COMPENSATION = (0.01, 0.03), 0.025, 200.0


def _gauss_1d(size: int, sigma: float, centre: float) -> np.ndarray:
    """Normalised 1-D Gaussian in float64 (the JAX windows' factor)."""
    g = np.exp(-((np.arange(size, dtype=np.float64) - centre) ** 2) / (2.0 * sigma**2))
    return g / g.sum()


def _filter_sep(x: torch.Tensor, g: np.ndarray, pad: int) -> torch.Tensor:
    """Depthwise 2-D filter of NCHW `x` with the window outer(g, g),
    zero-padded by `pad` (0: VALID), as two 1-D passes."""
    c = x.shape[1]
    k = torch.as_tensor(g.astype(np.float32), device=x.device, dtype=x.dtype)
    x = F.conv2d(x, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(pad, 0), groups=c)
    return F.conv2d(x, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, pad), groups=c)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def _ssim_cs(x, y, g, c1, c2):
    """Per-sample mean SSIM and contrast-structure of NCHW images."""
    mu_x, mu_y = _filter_sep(x, g, 0), _filter_sep(y, g, 0)
    s_xx = _filter_sep(x * x, g, 0) - mu_x * mu_x
    s_yy = _filter_sep(y * y, g, 0) - mu_y * mu_y
    s_xy = _filter_sep(x * y, g, 0) - mu_x * mu_y
    cs = (2 * s_xy + c2) / (s_xx + s_yy + c2)
    ssim = ((2 * mu_x * mu_y + c1) / (mu_x**2 + mu_y**2 + c1)) * cs
    return ssim.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def ms_ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Per-sample MS-SSIM [B] of NHWC images in [0, max_val]."""
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    g = _gauss_1d(_WINDOW, _SIGMA, _WINDOW // 2)
    # the scales that keep the window valid after repeated 2× pooling
    min_side = min(x.shape[1], x.shape[2])
    levels = 1
    while levels < 5 and (min_side // (2**levels)) >= _WINDOW:
        levels += 1
    weights = _MSSSIM_WEIGHTS[:levels] / _MSSSIM_WEIGHTS[:levels].sum()

    x, y = _nchw(x), _nchw(y)
    vals = []
    for lvl in range(levels):
        ssim_v, cs_v = _ssim_cs(x, y, g, c1, c2)
        vals.append(ssim_v if lvl == levels - 1 else cs_v)
        if lvl != levels - 1:
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
    vals = torch.stack(vals)  # [levels, B]; clipped as jnp.clip (its gradient at a bound)
    vals = torch.minimum(torch.maximum(vals, vals.new_tensor(1e-6)), vals.new_tensor(1.0))
    w = torch.as_tensor(weights.astype(np.float32), device=vals.device)[:, None]
    return torch.prod(vals**w, dim=0)


def ms_ssim_loss(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean (1 − MS-SSIM), the pooled Wang form."""
    return torch.mean(1.0 - ms_ssim(x, y, max_val=max_val))


def ms_ssim_mix_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """kornia `MS_SSIMLoss(reduction='mean')` analogue on NHWC images at
    its defaults: compensation · mean(alpha · (1 − lM · PIcs) + (1 −
    alpha) · gaussian_l1), lM the product over channels of the coarsest
    scale's luminance, PIcs the product over every scale and channel of
    the contrast-structure term."""
    c1, c2 = _K[0] ** 2, _K[1] ** 2
    size = int(4 * _KORNIA_SIGMAS[-1] + 1)  # 33
    pad = int(2 * _KORNIA_SIGMAS[-1])  # 16
    x, y = _nchw(x), _nchw(y)
    c = x.shape[1]
    # the five maps each scale filters, one grouped pass for all of them
    maps = torch.cat([x, y, x * x, y * y, x * y], dim=1)
    pics = lum = None
    for sigma in _KORNIA_SIGMAS:
        g = _gauss_1d(size, sigma, (size - 1) / 2.0)
        mu_x, mu_y, e_xx, e_yy, e_xy = _filter_sep(maps, g, pad).split(c, dim=1)
        mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        lum = (2 * mu_xy + c1) / (mu_x2 + mu_y2 + c1)  # [B, C, H, W]
        cs = (2 * (e_xy - mu_xy) + c2) / ((e_xx - mu_x2) + (e_yy - mu_y2) + c2)
        cs_prod = torch.prod(cs, dim=1)  # over channels
        pics = cs_prod if pics is None else pics * cs_prod
    loss_ms_ssim = 1.0 - torch.prod(lum, dim=1) * pics  # [B, H, W]
    g = _gauss_1d(size, _KORNIA_SIGMAS[-1], (size - 1) / 2.0)
    gaussian_l1 = _filter_sep((x - y).abs(), g, pad).mean(dim=1)
    loss_mix = _ALPHA * loss_ms_ssim + (1.0 - _ALPHA) * gaussian_l1
    return _COMPENSATION * loss_mix.mean()
