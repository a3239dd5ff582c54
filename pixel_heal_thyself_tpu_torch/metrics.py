"""Evaluation metrics with reference-quirk parity (copy of the JAX
package's `pixel_heal_thyself_tpu/metrics.py`; OpenCV is imported only by
the SSIM).

Behavioral spec: reference `pht/models/afgsa/metric.py` —
- PSNR (:9-24): on [0,255] arrays, float64, returns 0.0 when mse == 0
  (quirk preserved); 4-D input sums over the batch.
- SSIM (:27-76): hand-rolled 11×11 Gaussian-window SSIM via cv2.filter2D
  with a 5-px valid crop; the reference's 3-channel path computes the same
  full-array SSIM three times and averages — numerically identical to
  computing it once, which is what we do.
- RMSE (:79-94): actually relative MSE, 0.5·mean((a−b)²/(b²+0.01)) in
  linear HDR; 4-D input sums over the batch.
"""

from __future__ import annotations

import math

import numpy as np


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    if img1.ndim == 4:
        return sum(calculate_psnr(a, b) for a, b in zip(img1, img2))
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return 0.0
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    import cv2  # only the SSIM needs OpenCV

    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    kernel = cv2.getGaussianKernel(11, 1.5)
    window = np.outer(kernel, kernel.transpose())

    mu1 = cv2.filter2D(img1, -1, window)[5:-5, 5:-5]
    mu2 = cv2.filter2D(img2, -1, window)[5:-5, 5:-5]
    mu1_sq = mu1**2
    mu2_sq = mu2**2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = cv2.filter2D(img1**2, -1, window)[5:-5, 5:-5] - mu1_sq
    sigma2_sq = cv2.filter2D(img2**2, -1, window)[5:-5, 5:-5] - mu2_sq
    sigma12 = cv2.filter2D(img1 * img2, -1, window)[5:-5, 5:-5] - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 4:
        return sum(calculate_ssim(a, b) for a, b in zip(img1, img2))
    if img1.ndim == 2:
        return _ssim(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            # reference averages 3 identical full-array SSIMs — same value
            return _ssim(img1, img2)
        if img1.shape[2] == 1:
            return _ssim(np.squeeze(img1), np.squeeze(img2))
        raise ValueError("Wrong number of channels!")
    raise ValueError("Wrong input image dimensions!")


def calculate_rmse(img1: np.ndarray, img2: np.ndarray) -> float:
    """Relative MSE in linear HDR (the reference's 'RMSE')."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions!")
    if img1.ndim == 4:
        return sum(calculate_rmse(a, b) for a, b in zip(img1, img2))
    num = (img1 - img2) ** 2
    denom = img2**2 + 1.0e-2
    return 0.5 * float(np.mean(num / denom))
