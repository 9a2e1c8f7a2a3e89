"""Rendering quality metrics: PSNR (valid-depth masked), SSIM, MS-SSIM, and
the LPIPS weight loader.

The port's own copy of the numpy part of dnsjax/eval/render_metrics.py,
equal to it (the port imports nothing of dnsjax; tests/test_torch_shared.py
holds the two together). The LPIPS distance itself is ``eval/lpips.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def psnr(gt: np.ndarray, pred: np.ndarray, mask: Optional[np.ndarray] = None) -> float:
    """Peak signal-to-noise (images in [0,1]); optional pixel mask."""
    se = (np.asarray(gt, np.float64) - np.asarray(pred, np.float64)) ** 2
    if mask is not None:
        m = np.broadcast_to(np.asarray(mask, bool)[..., None] if se.ndim == 3 and mask.ndim == 2 else mask, se.shape)
        mse = se[m].mean()
    else:
        mse = se.mean()
    return float(-10.0 * math.log10(max(mse, 1e-12)))


def _gauss_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(ax**2) / (2 * sigma**2))
    k = k / k.sum()
    return np.outer(k, k)


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'valid' 2D correlation per channel via FFT-free sliding windows."""
    from numpy.lib.stride_tricks import sliding_window_view

    kh, kw = kernel.shape
    win = sliding_window_view(img, (kh, kw), axis=(0, 1))
    return np.einsum("ij...kl,kl->ij...", win, kernel)


def ssim(
    gt: np.ndarray,
    pred: np.ndarray,
    data_range: float = 1.0,
    win_size: int = 11,
    sigma: float = 1.5,
    full: bool = False,
):
    """Structural similarity (mean over image; channels averaged)."""
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    if gt.ndim == 2:
        gt = gt[..., None]
        pred = pred[..., None]
    # shrink the window for small images (keep it odd)
    m = min(gt.shape[0], gt.shape[1])
    if win_size > m:
        win_size = m if m % 2 == 1 else m - 1
    k = _gauss_kernel(win_size, sigma)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2

    mu1 = _filter2(gt, k)
    mu2 = _filter2(pred, k)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2(gt * gt, k) - mu1_sq
    s2 = _filter2(pred * pred, k) - mu2_sq
    s12 = _filter2(gt * pred, k) - mu12

    cs_map = (2 * s12 + C2) / (s1 + s2 + C2)
    ssim_map = ((2 * mu12 + C1) / (mu1_sq + mu2_sq + C1)) * cs_map
    if full:
        return float(ssim_map.mean()), float(cs_map.mean())
    return float(ssim_map.mean())


_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(gt: np.ndarray, pred: np.ndarray, data_range: float = 1.0) -> float:
    """Multi-scale SSIM (5 scales, standard weights, 2x average-pool between)."""
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    if gt.ndim == 2:
        gt = gt[..., None]
        pred = pred[..., None]

    def pool2(x):
        h, w = x.shape[0] // 2 * 2, x.shape[1] // 2 * 2
        x = x[:h, :w]
        return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])

    # use as many of the 5 scales as the image supports (smallest scale must
    # still be at least a few pixels for a meaningful window)
    n_scales = len(_MS_WEIGHTS)
    while n_scales > 1 and min(gt.shape[0], gt.shape[1]) >> (n_scales - 1) < 8:
        n_scales -= 1
    weights = np.asarray(_MS_WEIGHTS[:n_scales])
    weights = weights / weights.sum() * sum(_MS_WEIGHTS)

    vals = []
    for i in range(n_scales):
        s, cs = ssim(gt, pred, data_range, full=True)
        vals.append(s if i == n_scales - 1 else cs)
        if i < n_scales - 1:
            gt, pred = pool2(gt), pool2(pred)
    vals = np.clip(np.asarray(vals), 1e-6, None)
    return float(np.prod(vals ** weights))


# LPIPS weights (Zhang et al. 2018, AlexNet backbone) come from an .npz at
# $DNSJAX_LPIPS_NPZ with keys
#   conv{i}_w (Cout, Cin, kh, kw), conv{i}_b (Cout,)   i in 0..4
#   lin{i}_w  (Ci,)                                    i in 0..4
#   shift (3,), scale (3,)
# ``scripts/export_lpips.py`` converts the torch ``lpips`` package's
# checkpoint to this schema.


def load_lpips_params(path: str) -> dict:
    """Load and validate an LPIPS npz (see module comment for the schema)."""
    raw = np.load(path)
    params = {"convs": [], "lins": []}
    for i in range(5):
        w = np.asarray(raw[f"conv{i}_w"], np.float32)
        b = np.asarray(raw[f"conv{i}_b"], np.float32)
        lin = np.asarray(raw[f"lin{i}_w"], np.float32)
        if w.ndim != 4 or b.shape != (w.shape[0],) or lin.shape != (w.shape[0],):
            raise ValueError(f"bad LPIPS weight shapes at layer {i}")
        params["convs"].append((w, b))
        params["lins"].append(np.maximum(lin, 0.0))  # heads are non-negative
    params["shift"] = np.asarray(raw["shift"], np.float32).reshape(1, 3, 1, 1)
    params["scale"] = np.asarray(raw["scale"], np.float32).reshape(1, 3, 1, 1)
    return params
