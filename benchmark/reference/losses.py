"""The benchmark's reference: a frozen plain copy of dnsjax_torch/losses/losses.py.

Loss terms for tracking and mapping, PyTorch port of dnsjax/losses/losses.py.

All losses are fixed-shape: every ray is kept and a mask-weighted mean
replaces the reference's boolean gather.
"""

from __future__ import annotations

from typing import Tuple

import torch

def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean of x over elements where mask is truthy. mask broadcasts to x."""
    m = torch.broadcast_to(mask.to(x.dtype), x.shape)
    return (x * m).sum() / (m.sum() + eps)


def photometric_loss(gt_color, pred_color, mask=None) -> torch.Tensor:
    sq = (gt_color - pred_color) ** 2
    if mask is None:
        return sq.mean()
    return masked_mean(sq, mask[..., None])


def depth_l1_loss(gt_depth, pred_depth, mask=None) -> torch.Tensor:
    valid = gt_depth > 0
    if mask is not None:
        valid = valid & mask.to(torch.bool)
    return masked_mean((gt_depth - pred_depth).abs(), valid)


def depth_var_loss(gt_depth, pred_depth, pred_depth_var, mask) -> torch.Tensor:
    err = (gt_depth - pred_depth).abs() / torch.sqrt(pred_depth_var + 1e-10)
    return masked_mean(err, mask)


def semantic_ce_loss(gt_label, pred_logits, mask=None) -> torch.Tensor:
    logp = torch.log_softmax(pred_logits, -1)
    lbl = torch.clamp(gt_label.to(torch.int64), 0, pred_logits.shape[-1] - 1)
    nll = -torch.gather(logp, -1, lbl[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    return masked_mean(nll, mask)


def latent_distill_loss(coarse_latents, fine_latents, mask=None) -> torch.Tensor:
    sq = (coarse_latents - fine_latents) ** 2
    if mask is None:
        return sq.mean()
    return masked_mean(sq, mask)


def tv_smoothness_loss(occ_grid: torch.Tensor) -> torch.Tensor:
    """TV smoothness of a (G, G, G) occupancy sub-grid, normalised by (G+1)^3."""
    g = occ_grid.shape[0] + 1
    tv_x = ((occ_grid[1:] - occ_grid[:-1]) ** 2).sum()
    tv_y = ((occ_grid[:, 1:] - occ_grid[:, :-1]) ** 2).sum()
    tv_z = ((occ_grid[:, :, 1:] - occ_grid[:, :, :-1]) ** 2).sum()
    return (tv_x + tv_y + tv_z) / float(g**3)


def approx_occ(x: torch.Tensor, sigma: float) -> torch.Tensor:
    return 0.5 * torch.exp(-0.5 * (x / sigma) ** 2)


def freespace_opacity_loss(
    z_vals, gt_depth, occ_logits, ray_mask=None, truncation: float = 0.2,
    sigma: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Free-space + opacity losses against a Gaussian pseudo-occupancy; means
    over the full (rays x samples) tensor, weighted by the valid-ray mask."""
    occ = torch.sigmoid(10.0 * occ_logits)
    depth = gt_depth[..., None]
    front = (z_vals < depth - truncation).to(occ.dtype)
    back = (z_vals > depth + truncation).to(occ.dtype)
    has_depth = (depth > 0.0).to(occ.dtype)
    opacity_mask = (1.0 - front) * (1.0 - back) * has_depth
    if ray_mask is None:
        denom = torch.ones(occ.shape[:1], dtype=occ.dtype, device=occ.device)
    else:
        denom = ray_mask.to(occ.dtype)
    w = denom[..., None]
    n = denom.sum() * occ.shape[-1] + 1e-8
    fs_loss = (((occ * front * has_depth) ** 2) * w).sum() / n
    pseudo = approx_occ(z_vals - depth, sigma=sigma)
    op_loss = (((occ * opacity_mask - pseudo * opacity_mask) ** 2) * w).sum() / n
    return fs_loss, op_loss
