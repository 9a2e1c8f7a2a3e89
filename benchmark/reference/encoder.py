"""The benchmark's reference: a frozen plain copy of
dnsjax_torch/models/encoder.py (the procedural filter bank only).

Frozen 2D image encoder, PyTorch port of dnsjax/models/encoder.py.

ResNet-18's first stage only: conv 7x7 stride 2 (3 -> 64) + folded BN +
ReLU, never trained. The default filter bank is dnsjax's procedural Gabor /
centre-surround bank (same numbers); ``tpu.encoder_init: random`` draws a
seeded He-normal kernel instead, from a ``torch.Generator``, so its numbers
are not dnsjax's (torch cannot reproduce ``jax.random.normal``: a test
carries dnsjax's draw across with ``params_from_numpy``).
``DNSJAX_RESNET18_NPZ`` may point to pretrained conv1 + bn1 weights, and
then takes precedence over both. Images and features are NHWC and the kernel
HWIO, as in dnsjax.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as Fn

from benchmark.reference.mlp import _round


def _gabor_bank() -> np.ndarray:
    """(7,7,3,64) HWIO: 48 oriented even/odd Gabors (8 orientations x 3
    scales x 2 phases, grayscale) + 16 colour-opponent centre-surround
    blobs. Zero-mean, unit norm times sqrt(2)."""
    y, x = np.mgrid[-3:4, -3:4].astype(np.float64)
    filters = []
    for wavelength, sigma in ((3.5, 1.6), (5.0, 2.2), (8.0, 3.0)):
        for k in range(8):
            th = np.pi * k / 8
            xr = x * np.cos(th) + y * np.sin(th)
            yr = -x * np.sin(th) + y * np.cos(th)
            env = np.exp(-(xr**2 + (0.8 * yr) ** 2) / (2 * sigma**2))
            for phase in (0.0, np.pi / 2):
                g = env * np.cos(2 * np.pi * xr / wavelength + phase)
                g -= g.mean()
                filters.append(np.repeat(g[:, :, None], 3, axis=2) / np.sqrt(3))

    def dog(sigma_c):
        center = np.exp(-(x**2 + y**2) / (2 * sigma_c**2))
        surround = np.exp(-(x**2 + y**2) / (2 * (2.2 * sigma_c) ** 2))
        return center / center.sum() - surround / surround.sum()

    opponents = ((1.0, -1.0, 0.0), (-0.5, -0.5, 1.0), (0.577, 0.577, 0.577))
    for sigma_c in (1.0, 2.0):
        for opp in opponents:
            for sign in (1.0, -1.0):
                filters.append(sign * dog(sigma_c)[:, :, None] * np.asarray(opp)[None, None, :])
    for sigma_c, sign in ((0.7, 1.0), (0.7, -1.0), (3.0, 1.0), (3.0, -1.0)):
        filters.append(sign * dog(sigma_c)[:, :, None] * np.full(3, 0.577)[None, None, :])
    w = np.stack(filters, axis=-1)
    w /= np.sqrt((w**2).sum(axis=(0, 1, 2), keepdims=True)) + 1e-12
    return (w * np.sqrt(2.0)).astype(np.float32)


def init_encoder_params(device="cpu") -> Dict[str, torch.Tensor]:
    """{"w": (7,7,3,64) HWIO, "scale": (64,), "bias": (64,)}: the procedural
    bank with BN folded to the identity (the port's ``tpu.encoder_init:
    gabor``, its default)."""
    return {"w": torch.as_tensor(_gabor_bank(), device=device),
            "scale": torch.ones(64, device=device), "bias": torch.zeros(64, device=device)}


def encode_images(params: Dict[str, torch.Tensor], images: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(..., H, W, 3) float images -> (..., ceil(H/2), ceil(W/2), 64) float32.

    In bf16 compute, images and kernel are rounded to bf16 and convolved in
    float32 (exact products, float32 sums), as the reference's
    ``preferred_element_type=float32`` conv does.
    """
    batch = images.shape[:-3]
    H, W = images.shape[-3], images.shape[-2]
    x = _round(images.reshape(-1, H, W, 3), compute_dtype)
    k = _round(params["w"], compute_dtype)
    y = Fn.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), stride=2, padding=3)
    y = torch.relu(y.permute(0, 2, 3, 1) * params["scale"] + params["bias"])
    return y.reshape(batch + y.shape[1:])
