"""The benchmark's reference: a frozen plain copy of dnsjax_torch/models/features.py.

2D feature matching, PyTorch port of dnsjax/models/features.py.

Project sample points into reference views, gather encoder features from
the half-resolution maps and fuse them with the merge MLP. Both lookups
are here: the nearest tap (``feature_taps: 1``, the shipped TPU profile)
and the bilinear 4 taps (``feature_taps: 4``, dnsjax's default and the
reference's, which its full-frame renderer always uses).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from benchmark.reference.rays import project_points, world_to_camera
from benchmark.reference.se3 import invert_se3
from benchmark.reference.decoder import DecoderSpec, merge_apply


def _row_gather(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Rows of (H, W, C) at integer (yi, xi), as one flat row gather."""
    H, W = img.shape[0], img.shape[1]
    return img.reshape(H * W, img.shape[2])[yi.to(torch.int64) * W + xi.to(torch.int64)]


def _bilinear(rows, x: torch.Tensor, y: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear sample at continuous coords clamped to an H x W map whose
    rows at integer (yi, xi) ``rows`` gathers."""
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return (rows(y0, x0) * (1 - fx) * (1 - fy) + rows(y0, x1) * fx * (1 - fy)
            + rows(y1, x0) * (1 - fx) * fy + rows(y1, x1) * fx * fy)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (H, W, C) at continuous pixel coords, clamped."""
    return _bilinear(lambda yi, xi: _row_gather(img, yi, xi), x, y, img.shape[0], img.shape[1])


def nearest_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Nearest sample of (H, W, C) at continuous pixel coords, clamped
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    H, W = img.shape[0], img.shape[1]
    xi = torch.clamp(torch.round(x), 0, W - 1).to(torch.int64)
    yi = torch.clamp(torch.round(y), 0, H - 1).to(torch.int64)
    return _row_gather(img, yi, xi)


def match_features_batched(
    params: Dict[str, Any],
    pts_w: torch.Tensor,
    refer_w2c: torch.Tensor,
    feats_half: torch.Tensor,
    cam: Dict[str, Any],
    bound: torch.Tensor,
    spec: DecoderSpec,
    compute_dtype=torch.bfloat16,
    taps: int = 1,
) -> torch.Tensor:
    """Merged pixel codes over T frames with one flat feature gather.

    Args:
      pts_w: (T, P, 3) world points per frame.
      refer_w2c: (T, R, 4, 4) world-to-camera of each frame's views.
      feats_half: (T, R, Hf, Wf, C) encoder features at half resolution.
      cam: H, W, fx, fy, cx, cy (full-resolution intrinsics).
      taps: 1 = nearest half-res tap; 4 = bilinear (the reference's
        upsample + nearest full-res pixel).
    Returns:
      (T, P, hidden_dim). Out-of-frustum or behind-camera samples contribute
      a zeroed pixel feature (but still a PE term) to the view mean.
    """
    if taps not in (1, 4):
        raise ValueError(f"taps must be 1 or 4, got {taps}")
    H, W = int(cam["H"]), int(cam["W"])
    T, R = refer_w2c.shape[0], refer_w2c.shape[1]
    Hf, Wf, C = feats_half.shape[-3:]

    pts_cam = world_to_camera(pts_w[:, None], refer_w2c)  # (T, R, P, 3)
    u, v, depth = project_points(pts_cam, cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    u = torch.round(u)
    v = torch.round(v)
    mask = (u > 0) & (u < W - 1) & (v > 0) & (v < H - 1) & (depth > 0)

    # full-res pixel -> half-res coordinate under align_corners upsampling
    gx = u * ((Wf - 1.0) / (W - 1.0))
    gy = v * ((Hf - 1.0) / (H - 1.0))
    flat = feats_half.reshape(T * R * Hf * Wf, C)
    base = (torch.arange(T * R, device=pts_w.device) * (Hf * Wf)).reshape(T, R, 1)
    if taps == 4:
        code = _bilinear(lambda yi, xi: flat[base + yi * Wf + xi], gx, gy, Hf, Wf)
    else:
        xi = torch.clamp(torch.round(gx), 0, Wf - 1).to(torch.int64)
        yi = torch.clamp(torch.round(gy), 0, Hf - 1).to(torch.int64)
        code = flat[base + yi * Wf + xi]
    code = code * mask[..., None]  # (T, R, P, C)

    refer_o = invert_se3(refer_w2c)[..., :3, 3]  # (T, R, 3)
    rel = pts_w[:, None, :, :] - refer_o[:, :, None, :]
    return merge_apply(params, rel, code, bound, spec, compute_dtype)


def match_features(params, pts_w, refer_w2c, feats_half, cam, bound, spec,
                   compute_dtype=torch.bfloat16, taps: int = 1) -> torch.Tensor:
    """Single frame: pts (P, 3), views (R, 4, 4), feats (R, Hf, Wf, C) -> (P, h)."""
    return match_features_batched(
        params, pts_w[None], refer_w2c[None], feats_half[None], cam, bound,
        spec, compute_dtype, taps,
    )[0]
