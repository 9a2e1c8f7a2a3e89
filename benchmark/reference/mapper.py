"""The benchmark's reference: a frozen plain copy of the mapping loss of
dnsjax_torch/slam/mapper.py (``MapConfig``, the TV sub-grid, ``MapLoss``
without its random draws, which it takes as input) and a keystep call's
iterations under a fresh Adam, as ``map_step`` runs them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from benchmark.reference.decoder import DecoderSpec, coarse_apply, param_leaves, pos_encode
from benchmark.reference.features import match_features_batched
from benchmark.reference.losses import (
    depth_l1_loss,
    freespace_opacity_loss,
    latent_distill_loss,
    photometric_loss,
    semantic_ce_loss,
    tv_smoothness_loss,
)
from benchmark.reference.pipeline import render_fine
from benchmark.reference.rays import ray_box_far, rays_from_uv
from benchmark.reference.sampling import sample_along_rays
from benchmark.reference.se3 import compose_c2w, invert_se3, quat_to_rotation


@dataclass(frozen=True)
class MapConfig:
    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float
    n_pixels: int = 2000
    n_samples: int = 32
    n_surface: int = 15
    lr: float = 5e-3
    ba_cam_lr: float = 5e-4
    lambda_p: float = 5.0
    lambda_d: float = 5.0
    lambda_l: float = 0.1
    lambda_sm: float = 1e-5
    lambda_fs: float = 10.0
    lambda_op: float = 10.0
    smooth_pts: int = 64
    smooth_voxel: float = 0.1
    smooth_margin: float = 0.05
    # TV term every k-th iteration, scaled by k (same expected penalty)
    smooth_every: int = 1
    opacity_sigma: float = 0.05
    truncation: float = 0.2
    feature_taps: int = 4

    @property
    def cam(self):
        return dict(H=self.H, W=self.W, fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy)


def smoothness_grid_pts01(bound: torch.Tensor, offset_u: torch.Tensor,
                          jitter: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Bound-normalised points of the randomly placed TV sub-grid:
    (smooth_pts-1)^3 cells of smooth_voxel, offset by ``offset_u`` (3,) and
    jittered by ``jitter`` (3,), both uniform in [0, 1). Returns (g^3, 3)."""
    g = cfg.smooth_pts - 1
    extent = bound[:, 1] - bound[:, 0]
    offset_max = extent - g * cfg.smooth_voxel - 2 * cfg.smooth_margin
    offset = offset_u * offset_max + cfg.smooth_margin
    ax = torch.arange(g, dtype=torch.float32, device=bound.device)
    coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    pts = (coords + jitter) * cfg.smooth_voxel + bound[:, 0] + offset
    return ((pts - bound[:, 0]) / extent).reshape(-1, 3)


def smoothness_grid_occ(params, spec, pts01, cfg: MapConfig, compute_dtype):
    """Occupancy logits on the TV sub-grid, (g, g, g)."""
    g = cfg.smooth_pts - 1
    pe, grid = pos_encode(params, pts01, spec)
    return coarse_apply(params, pe, grid, compute_dtype)[:, 0].reshape(g, g, g)


class MapLoss:
    """The per-iteration mapping loss over a window of ``n_target`` frames.

    Window dict layout (tensors on the compute device):
      colors (T,H,W,3), depths (T,H,W), labels (T,H,W) int32,
      sorted_idx (T,H*W) int32, offsets (T,C+1) int32,
      refer_feats (T,R,Hf,Wf,64), refer_fixed_c2w (T,R,4,4),
      refer_src (T,R) int64 (window position if the view is a live target,
        else -1), pose_train (T,) float (0 freezes a frame's pose),
      pose_src (T,) int64 (window slot whose live pose this slot renders
        with; padding slots point at a real slot), frame_valid (T,) float
        (optional), bound (3,2), lt_gate_iter int (lambda_lt = 0 while
        iter <= gate).
    """

    def __init__(self, spec: DecoderSpec, cfg: MapConfig, n_target: int,
                 compute_dtype=torch.bfloat16):
        self.spec, self.cfg, self.T, self.dtype = spec, cfg, n_target, compute_dtype
        n_pix = cfg.n_pixels // n_target
        self.n_uni = n_pix // 3 * 2
        self.n_bal = n_pix // 3
        self.n_ray = self.n_uni + self.n_bal
        self.S = cfg.n_samples + cfg.n_surface

    def smooth_iter(self, it: int) -> bool:
        return self.cfg.smooth_every <= 1 or it % self.cfg.smooth_every == 0

    def sample_targets(self, c2w_live, window, draws):
        """Ray batch of every target: gt colour/depth/label, rays, z values,
        points and the reference views' w2c."""
        cfg, T = self.cfg, self.T
        pix = draws["pix"]
        tix = torch.arange(T, device=pix.device)[:, None]
        gt_c = window["colors"].reshape(T, -1, 3)[tix, pix]
        gt_d = window["depths"].reshape(T, -1)[tix, pix]
        gt_l = window["labels"].reshape(T, -1)[tix, pix]
        i = (pix % cfg.W).to(torch.float32)
        j = (pix // cfg.W).to(torch.float32)
        rays_o, rays_d = rays_from_uv(i, j, c2w_live[:, None], cfg.fx, cfg.fy, cfg.cx, cfg.cy)
        far = ray_box_far(rays_o.detach(), rays_d.detach(), window["bound"])
        inside = far >= gt_d
        z = sample_along_rays(gt_d, cfg.n_samples, cfg.n_surface, far + 0.01,
                              draws["t_surf"], draws["t_zero"])
        pts = rays_o[:, :, None, :] + rays_d[:, :, None, :] * z[..., None]
        src = window["refer_src"]
        live = c2w_live.detach()[torch.clamp(src, 0, T - 1)]
        refer_c2w = torch.where((src >= 0)[..., None, None], live, window["refer_fixed_c2w"])
        return gt_c, gt_d, gt_l, z, pts, invert_se3(refer_c2w), inside

    def __call__(self, params, quads, Ts, window, draws, it: int):
        cfg, T, n_ray, S = self.cfg, self.T, self.n_ray, self.S
        c2w_live = compose_c2w(quat_to_rotation(quads), Ts)
        if "pose_src" in window:
            c2w_live = c2w_live[window["pose_src"]]
        gt_c, gt_d, gt_l, z, pts, refer_w2c, inside = self.sample_targets(
            c2w_live, window, draws
        )
        code = match_features_batched(
            params, pts.reshape(T, n_ray * S, 3), refer_w2c, window["refer_feats"],
            cfg.cam, window["bound"], self.spec, self.dtype, taps=cfg.feature_taps,
        ).reshape(T, n_ray, S, -1)
        dd = gt_d[..., None]
        trunc = (z >= dd * 0.95) & (z <= dd * 1.05) & (dd > 0)
        code = code * trunc[..., None]

        flat = lambda x: x.reshape((T * n_ray,) + tuple(x.shape[2:]))
        gt_c, gt_d, gt_l, z, pts, code, inside = map(
            flat, (gt_c, gt_d, gt_l, z, pts, code, inside)
        )
        out = render_fine(params, self.spec, pts, z, gt_l, code, window["bound"], self.dtype)

        if self.smooth_iter(it):
            p01 = smoothness_grid_pts01(window["bound"], draws["sm_offset"],
                                        draws["sm_jitter"], cfg)
            sm_loss = tv_smoothness_loss(
                smoothness_grid_occ(params, self.spec, p01, cfg, self.dtype)
            ) * float(max(cfg.smooth_every, 1))
        else:
            sm_loss = torch.zeros((), device=z.device)

        mask = inside
        if "frame_valid" in window:
            mask = mask & (torch.repeat_interleave(window["frame_valid"], n_ray) > 0)
        p_loss = photometric_loss(gt_c, out.color, mask)
        d_loss = depth_l1_loss(gt_d, out.depth, mask)
        l_loss = semantic_ce_loss(gt_l, out.logits, mask)
        lt_loss = latent_distill_loss(out.coarse_latents, out.fine_latents, mask[:, None, None])
        fs_loss, op_loss = freespace_opacity_loss(
            z, gt_d, out.fine_latents[..., 0], mask,
            truncation=cfg.truncation, sigma=cfg.opacity_sigma,
        )
        lambda_lt = 10.0 if it > int(window["lt_gate_iter"]) else 0.0
        loss = (
            cfg.lambda_p * p_loss + cfg.lambda_d * d_loss + cfg.lambda_l * l_loss
            + lambda_lt * lt_loss + cfg.lambda_sm * sm_loss
            + cfg.lambda_fs * fs_loss + cfg.lambda_op * op_loss
        )
        aux = {"p_loss": p_loss, "d_loss": d_loss, "l_loss": l_loss,
               "lt_loss": lt_loss, "sm_loss": sm_loss, "fs_loss": fs_loss,
               "op_loss": op_loss, "color": out.color.detach(), "depth": out.depth.detach()}
        return loss, aux


def run_keystep(loss_fn: MapLoss, params, quads0, Ts0, window, draws: List[Dict[str, Any]],
                lr_scale: float = 1.0):
    """A keystep call of ``len(draws)`` iterations from the map ``params``
    (updated in place) and the window poses (quads0, Ts0), with a fresh
    Adam of two groups (map at ``lr``, poses at ``ba_cam_lr``, both times
    ``lr_scale``; b1 0.9, b2 0.999, eps 1e-8) and the pose gradients masked
    by ``pose_train``, as ``map_step`` runs it. Returns (every iteration's
    loss (n,), the first iteration's gradients [map leaves..., quads, Ts],
    the poses after the last)."""
    cfg = loss_fn.cfg
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    quads = quads0.detach().clone().requires_grad_(True)
    Ts = Ts0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([{"params": leaves, "lr": cfg.lr * lr_scale},
                            {"params": [quads, Ts], "lr": cfg.ba_cam_lr * lr_scale}],
                           betas=(0.9, 0.999), eps=1e-8)
    pose_train = window["pose_train"][:, None]
    losses, first = [], None
    try:
        for it, d in enumerate(draws):
            opt.zero_grad(set_to_none=True)
            loss, _ = loss_fn(params, quads, Ts, window, d, it)
            loss.backward()
            quads.grad.mul_(pose_train)
            Ts.grad.mul_(pose_train)
            if first is None:
                first = [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                         for p in leaves + [quads, Ts]]
            opt.step()
            losses.append(loss.detach())
    finally:
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None
    return torch.stack(losses), first, quads.detach(), Ts.detach()
