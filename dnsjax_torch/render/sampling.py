"""Depth-guided z-value sampling along rays, PyTorch port of dnsjax/render/sampling.py.

The random draws are inputs (``t_surf``, ``t_zero``), so a caller can feed
the same numbers to both packages; ``draw_z_noise`` makes them from a
``torch.Generator``. The z order comes from ``torch.sort`` (the
``tpu.z_backend`` key is accepted and selects nothing: both of dnsjax's
backends give the same values).
"""

from __future__ import annotations

import torch

from dnsjax_torch.ops.oneblob import linspace01


def draw_z_noise(generator: torch.Generator, batch: tuple, n_surface: int, device):
    """(t_surf, t_zero), each (*batch, n_surface) uniform in [0, 1)."""
    shape = tuple(batch) + (n_surface,)
    t_surf = torch.rand(shape, generator=generator, device=device)
    t_zero = torch.rand(shape, generator=generator, device=device)
    return t_surf, t_zero


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
        t_surf[..., pin] = 0.5
        z_valid = gt_depth[..., None] * (0.95 + 0.1 * t_surf[..., None, :])
        z_zero = 1e-3 * (1.0 - t_zero) + max_depth * t_zero  # (..., n_surface)
        parts.append(torch.where((gt_depth > 0)[..., None], z_valid, z_zero[..., None, :]))
    return torch.sort(torch.cat(parts, -1), dim=-1).values
