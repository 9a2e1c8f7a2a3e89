"""The benchmark's reference: a frozen plain copy of the Adam pose solve of
dnsjax_torch/slam/tracker.py (one device, no early exit), which takes each
iteration's random draws as input.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from benchmark.reference.features import match_features
from benchmark.reference.losses import depth_var_loss, photometric_loss, semantic_ce_loss
from benchmark.reference.pipeline import render_coarse
from benchmark.reference.rays import ray_box_far, rays_from_uv
from benchmark.reference.sampling import sample_along_rays
from benchmark.reference.se3 import compose_c2w, invert_se3, quat_to_rotation


@dataclass(frozen=True)
class TrackConfig:
    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float
    n_iters: int = 50
    n_pixels: int = 500
    n_samples: int = 32
    n_surface: int = 15
    ignore_edge: int = 20
    cam_lr: float = 1e-3
    separate_lr: bool = False
    lr_decay: float = 1.0      # 1.0: constant lr
    feature_taps: int = 4
    lambda_p: float = 5.0
    lambda_d: float = 5.0
    lambda_l: float = 0.1

    @property
    def cam(self):
        return dict(H=self.H, W=self.W, fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy)


class Tracker:
    """The Adam pose solve against a frozen map."""

    def __init__(self, spec, cfg: TrackConfig, compute_dtype=torch.float32):
        self.spec, self.cfg, self.dtype = spec, cfg, compute_dtype

    def forward(self, quad, T, frame: Dict[str, Any], draws):
        """Batch assembly + coarse render at pose (quad, T). ``frame``:
        params, enc_feats (2,Hf,Wf,C), refer_w2c (4,4), colorf (HW,3),
        depthf (HW,), labelf (HW,), bound (3,2)."""
        cfg = self.cfg
        c2w = compose_c2w(quat_to_rotation(quad), T)
        w2c = invert_se3(c2w)
        pix = draws["pix"]
        gt_c, gt_d, gt_l = frame["colorf"][pix], frame["depthf"][pix], frame["labelf"][pix]
        i = (pix % cfg.W).to(torch.float32)
        j = (pix // cfg.W).to(torch.float32)
        rays_o, rays_d = rays_from_uv(i, j, c2w, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
        far = ray_box_far(rays_o.detach(), rays_d.detach(), frame["bound"])
        inside = far >= gt_d
        z = sample_along_rays(gt_d, cfg.n_samples, cfg.n_surface, far + 0.01,
                              draws["t_surf"], draws["t_zero"])
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        S = z.shape[-1]
        # 2D features from [frozen reference view, live current view]
        code = match_features(
            frame["params"], pts.reshape(-1, 3), torch.stack([frame["refer_w2c"], w2c]),
            frame["enc_feats"], cfg.cam, frame["bound"], self.spec, self.dtype,
            taps=cfg.feature_taps,
        ).reshape(cfg.n_pixels, S, -1)
        dd = gt_d[:, None]
        trunc = (z >= dd * 0.95) & (z <= dd * 1.05) & (dd > 0)
        out = render_coarse(frame["params"], self.spec, pts, z, code * trunc[..., None],
                            frame["bound"], self.dtype)
        return out, gt_c, gt_d, gt_l, (gt_d > 0.01) & inside

    def losses_from(self, out, gt_c, gt_d, gt_l, mask):
        cfg = self.cfg
        p = photometric_loss(gt_c, out.color, mask)
        d = depth_var_loss(gt_d, out.depth, out.depth_var, mask)
        l = semantic_ce_loss(gt_l, out.logits, mask)
        return cfg.lambda_p * p + cfg.lambda_d * d + cfg.lambda_l * l, p, d

    def adam_grad(self, quad, T, frame, draws):
        """(loss, p, d) at (quad, T) and the pose gradient (g_quad, g_T)."""
        q = quad.detach().requires_grad_(True)
        t = T.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, p, d = self.losses_from(*self.forward(q, t, frame, draws))
            gq, gt = torch.autograd.grad(loss, (q, t))
        return (loss.detach(), p.detach(), d.detach()), (gq, gt)

    def adam_step(self, pose, mom, vel, grads, step: int):
        """One Adam update of pose = [quad, T] at step ``step`` (0-based):
        b1 0.9, b2 0.999, eps 1e-8, in optax.adam's order."""
        cfg = self.cfg
        b1, b2, eps, t = 0.9, 0.999, 1e-8, step + 1
        lr = cfg.cam_lr * (cfg.lr_decay ** (step / cfg.n_iters) if cfg.lr_decay < 1.0 else 1.0)
        lrs = (lr, lr * 0.2 if cfg.separate_lr else lr)
        mom = [(1 - b1) * g + b1 * m for g, m in zip(grads, mom)]
        vel = [(1 - b2) * g * g + b2 * v for g, v in zip(grads, vel)]
        pose = [x + -lr * ((m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps))
                for x, lr, m, v in zip(pose, lrs, mom, vel)]
        return pose, mom, vel

    def track_adam(self, frame, quad0, T0, draws: List[Dict[str, Any]]):
        """The Adam solve over ``draws`` (one an iteration): (best loss,
        quad, T, p, d), the lowest-loss pose it evaluated, and every
        iteration's loss."""
        inf = torch.tensor(float("inf"), device=quad0.device)
        best = (inf, quad0, T0, inf, inf)
        pose = [quad0, T0]
        mom = [torch.zeros_like(x) for x in pose]
        vel = [torch.zeros_like(x) for x in pose]
        losses = []
        for it, d in enumerate(draws):
            (loss, p, dl), grads = self.adam_grad(pose[0], pose[1], frame, d)
            best, _ = self._keep(best, loss, pose[0], pose[1], p, dl)
            losses.append(loss)
            pose, mom, vel = self.adam_step(pose, mom, vel, grads, it)
        return best, torch.stack(losses)

    @staticmethod
    def _keep(best, loss, quad, T, p, d):
        """The min-loss candidate updated with (loss, quad, T, p, d)."""
        better = loss < best[0]
        return tuple(torch.where(better, n, o) for n, o in zip((loss, quad, T, p, d), best)), better
