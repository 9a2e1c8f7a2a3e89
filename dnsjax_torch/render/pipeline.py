"""Field query + compositing, PyTorch port of dnsjax/render/pipeline.py:
``render_coarse`` (tracking: coarse head only) and ``render_fine`` (mapping:
class-dispatched fine heads, plus coarse latents for distillation), which
``render_fine_encoded`` continues from the grid encode's output."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dnsjax_torch.models.decoder import (
    blob_encode,
    coarse_apply,
    fine_apply,
    grid_encode,
    out_apply,
    pos_encode,
)
from dnsjax_torch.render.composite import composite_channels, composite_rays


class RenderOut(NamedTuple):
    color: torch.Tensor           # (N, 3)
    depth: torch.Tensor           # (N,)
    depth_var: torch.Tensor       # (N,)
    logits: torch.Tensor          # (N, n_class)
    weights: torch.Tensor         # (N, S)
    fine_latents: torch.Tensor    # (N, S, h+1)
    coarse_latents: torch.Tensor  # (N, S, h+1)


def normalize_pts(pts_w: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """World points -> [0,1]^3 by the scene bound."""
    return (pts_w - bound[:, 0]) / (bound[:, 1] - bound[:, 0])


def render_coarse(params, spec, pts_w, z_vals, pixel_code, bound,
                  compute_dtype=torch.bfloat16) -> RenderOut:
    """pts_w (N, S, 3), z_vals (N, S), pixel_code (N, S, h)."""
    N, S, _ = pts_w.shape
    pe, grid = pos_encode(params, normalize_pts(pts_w, bound).reshape(N * S, 3), spec)
    latents = coarse_apply(params, pe, grid, compute_dtype)
    feat = torch.cat([latents[:, 1:], pixel_code.reshape(N * S, -1)], -1)
    color_pts, logits_pts = out_apply(params, pe, feat, compute_dtype)
    depth, depth_var, color, weights = composite_rays(
        color_pts.reshape(N, S, 3), latents[:, 0].reshape(N, S), z_vals
    )
    logits = composite_channels(weights, logits_pts.reshape(N, S, -1))
    lat = latents.reshape(N, S, -1)
    return RenderOut(color, depth, depth_var, logits, weights, lat, lat)


def render_fine(params, spec, pts_w, z_vals, classes, pixel_code, bound,
                compute_dtype=torch.bfloat16) -> RenderOut:
    """pts_w (N, S, 3), z_vals (N, S), classes (N,) per-ray GT class,
    pixel_code (N, S, h)."""
    N, S, _ = pts_w.shape
    pts01 = normalize_pts(pts_w, bound).reshape(N * S, 3)
    return render_fine_encoded(params, spec, pts01, grid_encode(params, pts01, spec), z_vals,
                               classes, pixel_code, compute_dtype)


def render_fine_encoded(params, spec, pts01, grid, z_vals, classes, pixel_code,
                        compute_dtype=torch.bfloat16) -> RenderOut:
    """``render_fine`` after the grid encode: pts01 (N*S, 3) the samples in
    [0,1]^3, grid (N*S, L*F) their grid features, z_vals (N, S)."""
    N, S = z_vals.shape
    pe = blob_encode(pts01, spec)
    coarse_latents = coarse_apply(params, pe, grid, compute_dtype)
    fine_latents = fine_apply(
        params, classes, pe.reshape(N, S, -1), grid.reshape(N, S, -1), compute_dtype
    )
    feat = torch.cat(
        [fine_latents[..., 1:].reshape(N * S, -1), pixel_code.reshape(N * S, -1)], -1
    )
    color_pts, logits_pts = out_apply(params, pe, feat, compute_dtype)
    depth, depth_var, color, weights = composite_rays(
        color_pts.reshape(N, S, 3), fine_latents[..., 0], z_vals
    )
    logits = composite_channels(weights, logits_pts.reshape(N, S, -1))
    return RenderOut(color, depth, depth_var, logits, weights,
                     fine_latents, coarse_latents.reshape(N, S, -1))
