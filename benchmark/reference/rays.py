"""The benchmark's reference: a frozen plain copy of dnsjax_torch/geometry/rays.py.

Ray generation, ray-box intersection and pinhole projection, PyTorch port
of dnsjax/geometry/rays.py.

Pixel (i, j): i is the column (x), j the row (y). Camera-frame ray direction
is ``[(i-cx)/fx, -(j-cy)/fy, -1]`` (-z forward); projection of a camera
point gives depth ``-z``, ``u = fx*x/(-z) + cx``, ``v = -fy*y/(-z) + cy``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pixel_dirs(i: torch.Tensor, j: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Camera-frame ray directions for pixel coords. (...,) -> (..., 3)."""
    return torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], -1)


def rays_from_uv(
    i: torch.Tensor, j: torch.Tensor, c2w: torch.Tensor, fx, fy, cx, cy
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for pixel coords under pose ``c2w`` (..., 4, 4); rays_d is not
    normalised. c2w's batch dims broadcast against those of i/j."""
    dirs = pixel_dirs(i, j, fx, fy, cx, cy)
    rays_d = (c2w[..., :3, :3] @ dirs[..., None])[..., 0]
    return c2w[..., :3, 3].expand_as(rays_d), rays_d


def ray_box_far(rays_o: torch.Tensor, rays_d: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Distance along each ray to its exit from the (3, 2) scene bound, with a
    sign-preserving epsilon on near-zero direction components."""
    d = rays_d[..., :, None]
    eps = torch.where(d < 0, -1e-9, 1e-9)
    d = torch.where(d.abs() < 1e-9, eps, d)
    t = (bound - rays_o[..., :, None]) / d
    return t.amax(-1).amin(-1)


def project_points(pts_cam: torch.Tensor, fx, fy, cx, cy, eps: float = 1e-5):
    """Camera-frame points -> (u, v, depth) with depth = -z."""
    depth = -pts_cam[..., 2]
    u = fx * pts_cam[..., 0] / (depth + eps) + cx
    v = -fy * pts_cam[..., 1] / (depth + eps) + cy
    return u, v, depth


def world_to_camera(pts_w: torch.Tensor, w2c: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) world points through (..., 4, 4) w2c -> (..., N, 3)."""
    R = w2c[..., :3, :3]
    t = w2c[..., :3, 3]
    return pts_w @ R.transpose(-1, -2) + t[..., None, :]
