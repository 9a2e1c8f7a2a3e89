"""Occupancy-based volume compositing, PyTorch port of dnsjax/render/composite.py.

alpha = sigmoid(10 * occupancy_logit), transmittance is the exclusive
cumulative product of (1 - alpha + 1e-10), and the weights are renormalised
to sum to one per ray.
"""

from __future__ import annotations

import torch


def render_weights(raw_occ: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """(N, S) occupancy logits -> (N, S) renormalised weights."""
    alpha = torch.sigmoid(10.0 * raw_occ)
    ones = torch.ones_like(alpha[..., :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + eps], -1), -1)[..., :-1]
    weights = alpha * trans
    return weights / (weights.sum(-1, keepdim=True) + eps)


def composite_rays(rgb, raw_occ, z_vals):
    """rgb (N, S, 3), raw_occ (N, S), z_vals (N, S) ->
    (depth (N,), depth_var (N,), color (N, 3), weights (N, S))."""
    weights = render_weights(raw_occ)
    color = (weights[..., None] * rgb).sum(-2)
    depth = (weights * z_vals).sum(-1)
    resid = z_vals - depth[..., None]
    depth_var = (weights * resid * resid).sum(-1)
    return depth, depth_var, color, weights


def composite_channels(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(N, S) weights x (N, S, C) -> (N, C)."""
    return (weights[..., None] * values).sum(-2)
