"""Depth-guided z-value sampling along rays, PyTorch port of dnsjax/render/sampling.py.

The random draws are inputs (``t_surf``, ``t_zero``), so a caller can feed
the same numbers to both packages; ``draw_z_noise`` makes them from a
``torch.Generator``, and ``key_z_noise`` makes the ones dnsjax draws from
``jax.random.PRNGKey(seed)`` (its evaluation renders seed each frame's key
with the frame index). The z order comes from ``torch.sort`` (the
``tpu.z_backend`` key is accepted and selects nothing: both of dnsjax's
backends give the same values).
"""

from __future__ import annotations

import numpy as np
import torch

from dnsjax_torch.ops.oneblob import linspace01


def draw_z_noise(generator: torch.Generator, batch: tuple, n_surface: int, device):
    """(t_surf, t_zero), each (*batch, n_surface) uniform in [0, 1)."""
    shape = tuple(batch) + (n_surface,)
    t_surf = torch.rand(shape, generator=generator, device=device)
    t_zero = torch.rand(shape, generator=generator, device=device)
    return t_surf, t_zero


def _threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 counter pairs,
    as jax.random's default key implementation computes it."""
    x = [x1.astype(np.uint32).copy(), x2.astype(np.uint32).copy()]
    ks = [np.uint32(k1), np.uint32(k2), np.uint32(k1 ^ k2 ^ 0x1BD11BDA)]
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x[0] += ks[0]
        x[1] += ks[1]
        for i in range(5):
            for r in rotations[i % 2]:
                x[0] += x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] ^= x[0]
            x[0] += ks[(i + 1) % 3]
            x[1] += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def key_z_noise(seed: int, n_surface: int, device):
    """(t_surf, t_zero), each (n_surface,), bit for bit the values of
    ``k_surf, k_zero = jax.random.split(jax.random.PRNGKey(seed))`` and
    ``jax.random.uniform(k, (n_surface,))`` that dnsjax's
    ``sample_along_rays`` draws (threefry keys, partitionable splits and
    bits: jax's defaults)."""
    count = np.arange(2, dtype=np.uint32)
    keys = _threefry2x32(0, seed, np.zeros(2, np.uint32), count)
    out = []
    for k in range(2):
        b1, b2 = _threefry2x32(int(keys[0][k]), int(keys[1][k]),
                               np.zeros(n_surface, np.uint32),
                               np.arange(n_surface, dtype=np.uint32))
        bits = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
        out.append(torch.as_tensor(bits.view(np.float32) - np.float32(1.0), device=device))
    return tuple(out)


def sample_along_rays(
    gt_depth: torch.Tensor,
    n_samples: int,
    n_surface: int,
    far_bb: torch.Tensor,
    t_surf: torch.Tensor,
    t_zero: torch.Tensor,
) -> torch.Tensor:
    """Sorted z values per ray, batched over leading dims.

    Args:
      gt_depth: (..., N) per-ray sensor depth (0 = invalid).
      far_bb: (..., N) far plane from the ray-box intersection (+0.01).
      t_surf, t_zero: (..., n_surface) draws shared by the N rays of a batch.
    Returns:
      (..., N, n_samples + n_surface) float32.

    Surface samples: uniform in [0.95 d, 1.05 d] with one entry pinned to the
    bracket midpoint, or for zero-depth rays uniform in [1e-3, max depth].
    Stratified samples: a linspace from 1e-3 d to clamp(far, 0, 1.2 max depth).
    """
    max_depth = gt_depth.amax(-1, keepdim=True)  # (..., 1)
    parts = []
    if n_samples > 0:
        near = 1e-3 * gt_depth
        far = torch.minimum(torch.clamp(far_bb, min=0.0), 1.2 * max_depth)
        t = linspace01(n_samples, gt_depth.device)
        parts.append(near[..., None] + t * (far - near)[..., None])
    if n_surface > 0:
        pin = min(n_surface // 2 + 1, n_surface - 1)
        t_surf = t_surf.clone()
        t_surf[..., pin].fill_(0.5)  # a device op: a CUDA graph can capture it
        z_valid = gt_depth[..., None] * (0.95 + 0.1 * t_surf[..., None, :])
        z_zero = 1e-3 * (1.0 - t_zero) + max_depth * t_zero  # (..., n_surface)
        parts.append(torch.where((gt_depth > 0)[..., None], z_valid, z_zero[..., None, :]))
    return torch.sort(torch.cat(parts, -1), dim=-1).values
