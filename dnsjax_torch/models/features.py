"""2D feature matching, PyTorch port of dnsjax/models/features.py.

Project sample points into reference views, gather encoder features from
the half-resolution maps and fuse them with the merge MLP. The slice ports
the nearest-tap lookup (``feature_taps: 1``); the bilinear 4-tap path is
still to be ported.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from dnsjax_torch.geometry.rays import project_points, world_to_camera
from dnsjax_torch.geometry.se3 import invert_se3
from dnsjax_torch.models.decoder import DecoderSpec, merge_apply


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
    Returns:
      (T, P, hidden_dim). Out-of-frustum or behind-camera samples contribute
      a zeroed pixel feature (but still a PE term) to the view mean.
    """
    if taps != 1:
        raise NotImplementedError(
            "tpu.feature_taps: 4 is not ported yet (ROADMAP.md, Queue 1: "
            "remaining items, 1)"
        )
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
    xi = torch.clamp(torch.round(gx), 0, Wf - 1).to(torch.int64)
    yi = torch.clamp(torch.round(gy), 0, Hf - 1).to(torch.int64)
    flat = feats_half.reshape(T * R * Hf * Wf, C)
    base = (torch.arange(T * R, device=pts_w.device) * (Hf * Wf)).reshape(T, R, 1)
    code = flat[base + yi * Wf + xi] * mask[..., None]  # (T, R, P, C)

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
