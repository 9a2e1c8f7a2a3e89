"""Camera tracking: the Levenberg-Marquardt pose solve, PyTorch port of
dnsjax/slam/tracker.py (``track_body_lm``).

Each LM iteration draws a fresh ray batch, builds the 7 x m Jacobian of the
weighted residual vector by forward mode (``torch.func.jvp`` under
``torch.func.vmap`` over the 7 pose tangents, through the hash encode's
``jvp``), forms the damped normal equations, solves, and accepts the trial
pose if the full scalar loss (which keeps the semantic CE term) drops on the
same batch. The min-loss candidate is kept as in the reference. The whole
solve stays on the device: accept/reject and the candidate use
``torch.where``, so the host reads one packed vector per frame.

The Adam schedule (``tracking.method: adam``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from dnsjax_torch.geometry.rays import ray_box_far, rays_from_uv
from dnsjax_torch.geometry.se3 import compose_c2w, invert_se3, quat_to_rotation
from dnsjax_torch.losses.losses import depth_var_loss, photometric_loss, semantic_ce_loss
from dnsjax_torch.models.features import match_features
from dnsjax_torch.render.pipeline import render_coarse
from dnsjax_torch.render.sampling import draw_z_noise, sample_along_rays
from dnsjax_torch.slam.sampling import sample_uniform_pixels


@dataclass(frozen=True)
class TrackConfig:
    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float
    n_pixels: int = 500
    n_samples: int = 32
    n_surface: int = 15
    ignore_edge: int = 20
    feature_taps: int = 1
    lm_iters: int = 10
    lm_lambda0: float = 1e-3   # initial damping (scaled by diag(JtJ))
    lm_up: float = 5.0         # damping multiplier on a rejected step
    lm_down: float = 0.5       # damping multiplier on an accepted step
    lambda_p: float = 5.0
    lambda_d: float = 5.0
    lambda_l: float = 0.1

    @property
    def cam(self):
        return dict(H=self.H, W=self.W, fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy)


class Tracker:
    """Per-frame LM tracking against a frozen map."""

    def __init__(self, spec, cfg: TrackConfig, compute_dtype=torch.bfloat16):
        self.spec, self.cfg, self.dtype = spec, cfg, compute_dtype

    def draw(self, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """One iteration's random numbers: pixels in the inner crop and the
        z-sampling uniforms."""
        cfg = self.cfg
        pix = sample_uniform_pixels(gen, cfg.n_pixels, cfg.H, cfg.W,
                                    cfg.ignore_edge, cfg.ignore_edge, device=device)
        t_surf, t_zero = draw_z_noise(gen, (), cfg.n_surface, device)
        return {"pix": pix, "t_surf": t_surf, "t_zero": t_zero}

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

    def resid(self, quad, T, frame, draws):
        """Weighted residual vector r (||r||^2 = lambda_p * photometric + an
        IRLS quadratic surrogate of the depth/sqrt(var) L1 term; weights
        frozen per linearisation) and the scalar losses (loss, p, d)."""
        cfg = self.cfg
        out, gt_c, gt_d, gt_l, mask = self.forward(quad, T, frame, draws)
        m = mask.to(torch.float32)
        n_valid = m.sum() + 1e-8
        lam_p = torch.full_like(n_valid, cfg.lambda_p)  # see se3.quat_to_rotation
        r_p = torch.sqrt(lam_p / (3.0 * n_valid)) * ((out.color - gt_c) * m[:, None])
        e_d = (out.depth - gt_d) * m
        s = torch.sqrt(out.depth_var + 1e-10)
        w_d = (cfg.lambda_d * m / (s * (e_d.abs() + 1e-3) * n_valid)).detach()
        r = torch.cat([r_p.reshape(-1), torch.sqrt(w_d) * e_d])
        return r, self.losses_from(out, gt_c, gt_d, gt_l, mask)

    def linearize(self, quad, T, frame, draws):
        """(r (m,), J (7, m), (loss, p, d)) at (quad, T)."""
        eye = torch.eye(7, dtype=torch.float32, device=quad.device)

        def one(tq, tT):
            return torch.func.jvp(
                lambda q, t: self.resid(q, t, frame, draws), (quad, T), (tq, tT),
                has_aux=True,
            )

        r, J, aux = torch.func.vmap(one)(eye[:, :4], eye[:, 4:])
        return r[0], J, tuple(a[0] for a in aux)

    @staticmethod
    def lm_delta(J, r, lam):
        """Marquardt-damped Gauss-Newton step: solve (JtJ + lam diag(JtJ) +
        1e-8 I) delta = -Jt r."""
        JTJ = J @ J.T
        A = JTJ + lam * torch.diag(torch.diagonal(JTJ)) + 1e-8 * torch.eye(7, device=J.device)
        return -torch.linalg.solve(A, J @ r)

    def lm_step(self, quad, T, lam, J, r):
        """The trial (quad, T) after one damped step, with the quaternion
        renormalised (quat_to_rotation is scale-invariant)."""
        delta = self.lm_delta(J, r, lam)
        q = quad + delta[:4]
        return q / torch.linalg.norm(q), T + delta[4:]

    def eval_loss(self, quad, T, frame, draws):
        with torch.no_grad():
            return self.resid(quad, T, frame, draws)[1]

    def track(self, params, enc_feats, refer_w2c, color, depth, label, quad0, T0,
              bound, gen: torch.Generator, draws=None) -> torch.Tensor:
        """LM pose solve. Returns the packed (10,) float32 vector
        [best quad (4), best T (3), best loss, p_loss, d_loss] on device.
        ``draws``: lm_iters + 1 iteration draws (default: from ``gen``)."""
        cfg = self.cfg
        dev = quad0.device
        frame = {"params": params, "enc_feats": enc_feats, "refer_w2c": refer_w2c,
                 "colorf": color.reshape(-1, 3), "depthf": depth.reshape(-1),
                 "labelf": label.reshape(-1), "bound": bound}
        if draws is None:
            draws = [self.draw(gen, dev) for _ in range(cfg.lm_iters + 1)]
        inf = torch.tensor(float("inf"), device=dev)
        quad, T = quad0, T0
        lam = torch.tensor(cfg.lm_lambda0, dtype=torch.float32, device=dev)
        best = (inf, quad0, T0, inf, inf)  # (loss, quad, T, p, d)

        def keep(best, loss, quad, T, p, d):
            better = loss < best[0]
            return tuple(torch.where(better, n, o) for n, o in zip((loss, quad, T, p, d), best))

        for it in range(cfg.lm_iters):
            r, J, (loss, p, d) = self.linearize(quad, T, frame, draws[it])
            best = keep(best, loss, quad, T, p, d)
            q_new, T_new = self.lm_step(quad, T, lam, J, r)
            new_loss = self.eval_loss(q_new, T_new, frame, draws[it])[0]
            accept = new_loss < loss
            quad = torch.where(accept, q_new, quad)
            T = torch.where(accept, T_new, T)
            lam = torch.clamp(torch.where(accept, lam * cfg.lm_down, lam * cfg.lm_up), 1e-7, 1e7)
        # the final accepted pose was never evaluated inside the loop
        loss_f, p_f, d_f = self.eval_loss(quad, T, frame, draws[-1])
        loss, bq, bT, p, d = keep(best, loss_f, quad, T, p_f, d_f)
        return torch.cat([bq, bT, torch.stack([loss, p, d])]).to(torch.float32)


def pose_init_const_velocity(est_c2w_list: np.ndarray, idx: int,
                             const_speed: bool = True) -> np.ndarray:
    """Constant-velocity pose initialisation."""
    pre = est_c2w_list[idx - 1]
    if const_speed and idx > 2:
        delta = pre @ np.linalg.inv(est_c2w_list[idx - 2])
        return (delta @ pre).astype(np.float32)
    return pre.astype(np.float32)
