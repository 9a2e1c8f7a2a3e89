"""Camera tracking, PyTorch port of dnsjax/slam/tracker.py: the reference's
Adam schedule (``track_body``, ``tracking.method: adam``) and the
Levenberg-Marquardt solve (``track_body_lm``, ``method: lm``).

Adam: each of ``n_iters`` iterations draws a fresh ray batch, renders the
coarse field at the current pose and takes the pose gradient by reverse
mode through the hash encode (its position gradient only: the map's
parameters do not require grad while tracking, so no table gradient runs),
then one optax-style Adam step (b1 0.9, b2 0.999, eps 1e-8; ``seperate_LR``
gives T 0.2x the lr; ``lr_decay < 1`` gives lr * decay^(step / n_iters)).

LM: each iteration draws a fresh ray batch, builds the 7 x m Jacobian of the
weighted residual vector by forward mode (``torch.func.jvp`` under
``torch.func.vmap`` over the 7 pose tangents, through the hash encode's
``jvp``), forms the damped normal equations, solves, and accepts the trial
pose if the full scalar loss (which keeps the semantic CE term) drops on the
same batch.

Both keep the min-loss candidate: the pose *at which* a loss was evaluated,
before that iteration's update, as in the reference; accept/reject and the
candidate use ``torch.where`` on the device. Early exit (``patience`` for
Adam, ``lm_patience`` for LM: stop once the candidate has not improved for
that many iterations) is a ``lax.while_loop`` in dnsjax; here the host reads
the iteration's "improved" flag, one sync an iteration, and skips the
iterations it no longer needs with their launches. A tracked frame is bound
by launches, not by the device, so the sync costs little. Without early exit
the host reads one packed vector a frame.

The Adam solve without early exit and without a ray mesh has fixed shapes
and reads nothing on the host, so where it may capture (``Tracker.replays``)
``track`` captures it whole, draws and packing aside, as one CUDA graph
(``slam/graphs.py``: ``solve_packed`` over static input buffers) and replays
it for every frame after copying in the map's parameters that the forward
reads, the frame, the initial pose and the 50 iterations' draws (drawn
ahead from ``gen`` in the loop's order). It is captured again only when an
input's shape or dtype changes. Each step's learning rate and bias
corrections are baked in as the loop computes them. A replay enters none of
the loop's host spans (``track.iter``, ``encode``, ``encode_bwd``); it opens
``track.replay``.

Under a ray mesh (``Tracker(mesh=)``, dnsjax's ``make_track_fn(mesh=)``)
every rank draws its own rays from its own generator, and each iteration's
loss, loss terms and pose gradient (Adam) or normal equations JtJ, Jtr
(LM) are averaged over the ranks before the update, as are the trial and
final losses the LM solve compares: every rank takes the same branches and
holds the same pose, and the early exit reads the averaged loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from dnsjax_torch import spans
from dnsjax_torch.geometry.rays import ray_box_far, rays_from_uv
from dnsjax_torch.geometry.se3 import compose_c2w, invert_se3, quat_to_rotation
from dnsjax_torch.losses.losses import depth_var_loss, photometric_loss, semantic_ce_loss
from dnsjax_torch.models.features import match_features
from dnsjax_torch.render.pipeline import render_coarse
from dnsjax_torch.render.sampling import draw_z_noise, sample_along_rays
from dnsjax_torch.slam import graphs
from dnsjax_torch.slam.sampling import sample_uniform_pixels


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
    patience: int = 0          # Adam early exit; 0 runs all n_iters
    method: str = "adam"       # "adam" | "lm"
    lm_iters: int = 10
    lm_patience: int = 0       # LM early exit; 0 runs all lm_iters
    lm_lambda0: float = 1e-3   # initial damping (scaled by diag(JtJ))
    lm_up: float = 5.0         # damping multiplier on a rejected step
    lm_down: float = 0.5       # damping multiplier on an accepted step
    lambda_p: float = 5.0
    lambda_d: float = 5.0
    lambda_l: float = 0.1

    @property
    def cam(self):
        return dict(H=self.H, W=self.W, fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy)


# the map's parameters that ``Tracker.forward`` reads
FORWARD_PARAMS = ("table", "coarse", "merge", "color", "logit")


class Tracker:
    """Per-frame pose tracking (Adam or LM) against a frozen map."""

    def __init__(self, spec, cfg: TrackConfig, compute_dtype=torch.bfloat16, mesh=None):
        if cfg.method not in ("adam", "lm"):
            raise ValueError(f"tracking.method={cfg.method!r}: expected adam|lm")
        self.spec, self.cfg, self.dtype, self.mesh = spec, cfg, compute_dtype, mesh
        self._graph = None  # (key, the captured solve) once ``track`` replays

    def _pmean(self, *tensors):
        """The tensors averaged over the ray mesh (as they are without one)."""
        return tuple(tensors) if self.mesh is None else tuple(self.mesh.pmean(tensors))

    def draw(self, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """One iteration's random numbers: pixels in the inner crop and the
        z-sampling uniforms."""
        cfg = self.cfg
        pix = sample_uniform_pixels(gen, cfg.n_pixels, cfg.H, cfg.W,
                                    cfg.ignore_edge, cfg.ignore_edge, device=device)
        t_surf, t_zero = draw_z_noise(gen, (), cfg.n_surface, device)
        return {"pix": pix, "t_surf": t_surf, "t_zero": t_zero}

    def draw_ahead(self, gen: torch.Generator, device) -> List[Dict[str, torch.Tensor]]:
        """The n_iters draws of an Adam solve without early exit, in the
        order its loop takes them from ``gen``."""
        return [self.draw(gen, device) for _ in range(self.cfg.n_iters)]

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
        return Tracker.lm_delta_normal(J @ J.T, J @ r, lam)

    @staticmethod
    def lm_delta_normal(JTJ, JTr, lam):
        """``lm_delta`` from the normal equations' JtJ (7, 7) and Jtr (7,)."""
        A = JTJ + lam * torch.diag(torch.diagonal(JTJ)) + 1e-8 * torch.eye(7, device=JTJ.device)
        return -torch.linalg.solve(A, JTr)

    def lm_step(self, quad, T, lam, J, r):
        """The trial (quad, T) after one damped step, with the quaternion
        renormalised (quat_to_rotation is scale-invariant)."""
        return self.lm_step_normal(quad, T, lam, J @ J.T, J @ r)

    def lm_step_normal(self, quad, T, lam, JTJ, JTr):
        """``lm_step`` from the normal equations."""
        delta = self.lm_delta_normal(JTJ, JTr, lam)
        q = quad + delta[:4]
        return q / torch.linalg.norm(q), T + delta[4:]

    def eval_loss(self, quad, T, frame, draws):
        """(loss, p, d) at (quad, T) on ``draws``, averaged over the mesh."""
        with torch.no_grad():
            return self._pmean(*self.resid(quad, T, frame, draws)[1])

    def adam_lr(self, step: int):
        """(quad lr, T lr) of Adam step ``step`` (0-based)."""
        cfg = self.cfg
        lr = cfg.cam_lr
        if cfg.lr_decay < 1.0:
            lr = lr * cfg.lr_decay ** (step / cfg.n_iters)
        return lr, (lr * 0.2 if cfg.separate_lr else lr)

    def adam_grad(self, quad, T, frame, draws):
        """(loss, p, d) at (quad, T) and the pose gradient (g_quad, g_T)."""
        q = quad.detach().requires_grad_(True)
        t = T.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, p, d = self.losses_from(*self.forward(q, t, frame, draws))
            gq, gt = torch.autograd.grad(loss, (q, t))
        loss, p, d, gq, gt = self._pmean(loss.detach(), p.detach(), d.detach(), gq, gt)
        return (loss, p, d), (gq, gt)

    @staticmethod
    def _keep(best, loss, quad, T, p, d):
        """The min-loss candidate updated with (loss, quad, T, p, d)."""
        better = loss < best[0]
        return tuple(torch.where(better, n, o) for n, o in zip((loss, quad, T, p, d), best)), better

    @staticmethod
    def _stalled(better, since: int, patience: int):
        """The early-exit counter after an iteration: (stop, since)."""
        if patience <= 0:
            return False, since
        since = 0 if bool(better) else since + 1
        return since >= patience, since

    def adam_step(self, pose, mom, vel, grads, step: int):
        """One Adam update of pose = [quad, T] at step ``step`` (0-based),
        optax.adam's arithmetic in its order (b1 0.9, b2 0.999, eps 1e-8);
        returns the new (pose, mom, vel) lists."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        lrs, t = self.adam_lr(step), step + 1
        mom = [(1 - b1) * g + b1 * m for g, m in zip(grads, mom)]
        vel = [(1 - b2) * g * g + b2 * v for g, v in zip(grads, vel)]
        pose = [x + -lr * ((m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps))
                for x, lr, m, v in zip(pose, lrs, mom, vel)]
        return pose, mom, vel

    def track_adam(self, frame, quad0, T0, draw):
        """Adam pose solve (dnsjax ``track_body``); (best, n_iters_run)."""
        cfg = self.cfg
        inf = torch.full((), float("inf"), device=quad0.device)  # no host copy
        best = (inf, quad0, T0, inf, inf)
        pose = [quad0, T0]
        mom = [torch.zeros_like(x) for x in pose]
        vel = [torch.zeros_like(x) for x in pose]
        since, it = 0, 0
        while it < cfg.n_iters:
            with spans.span("track.iter"):
                (loss, p, d), grads = self.adam_grad(pose[0], pose[1], frame, draw(it))
                best, better = self._keep(best, loss, pose[0], pose[1], p, d)
                pose, mom, vel = self.adam_step(pose, mom, vel, grads, it)
                it += 1
                stop, since = self._stalled(better, since, cfg.patience)
            if stop:
                break
        return best, it

    def track_lm(self, frame, quad0, T0, draw):
        """LM pose solve (dnsjax ``track_body_lm``); (best, n_iters_run)."""
        cfg = self.cfg
        dev = quad0.device
        inf = torch.tensor(float("inf"), device=dev)
        quad, T = quad0, T0
        lam = torch.tensor(cfg.lm_lambda0, dtype=torch.float32, device=dev)
        best = (inf, quad0, T0, inf, inf)  # (loss, quad, T, p, d)
        since, it = 0, 0
        while it < cfg.lm_iters:
            with spans.span("track.iter"):
                draws = draw(it)
                r, J, (loss, p, d) = self.linearize(quad, T, frame, draws)
                JTJ, JTr, loss, p, d = self._pmean(J @ J.T, J @ r, loss, p, d)
                best, better = self._keep(best, loss, quad, T, p, d)
                q_new, T_new = self.lm_step_normal(quad, T, lam, JTJ, JTr)
                new_loss = self.eval_loss(q_new, T_new, frame, draws)[0]
                accept = new_loss < loss
                quad = torch.where(accept, q_new, quad)
                T = torch.where(accept, T_new, T)
                lam = torch.clamp(torch.where(accept, lam * cfg.lm_down, lam * cfg.lm_up),
                                  1e-7, 1e7)
                it += 1
                stop, since = self._stalled(better, since, cfg.lm_patience)
            if stop:
                break
        # the final accepted pose was never evaluated inside the loop
        loss_f, p_f, d_f = self.eval_loss(quad, T, frame, draw(-1))
        best, _ = self._keep(best, loss_f, quad, T, p_f, d_f)
        return best, it

    @staticmethod
    def _pack(best) -> torch.Tensor:
        """[best quad (4), best T (3), best loss, p_loss, d_loss] float32."""
        loss, bq, bT, p, d = best
        return torch.cat([bq, bT, torch.stack([loss, p, d])]).to(torch.float32)

    def replays(self, device) -> bool:
        """Does ``track`` replay a captured solve on ``device``? Where
        ``graphs.capturable``, the Adam solve without early exit and
        without a ray mesh does: its shapes and its iterations are fixed,
        and it reads nothing on the host before its end."""
        cfg = self.cfg
        return (cfg.method == "adam" and cfg.patience <= 0 and self.mesh is None
                and graphs.capturable(device))

    @staticmethod
    def solve_inputs(params, enc_feats, refer_w2c, color, depth, label, quad0, T0, bound,
                     draws) -> Dict[str, Any]:
        """What ``solve_packed`` reads, as one tree of tensors; ``draws``:
        the n_iters iterations' draws, stacked."""
        return {"params": {k: params[k] for k in FORWARD_PARAMS}, "enc_feats": enc_feats,
                "refer_w2c": refer_w2c, "colorf": color.reshape(-1, 3),
                "depthf": depth.reshape(-1), "labelf": label.reshape(-1), "bound": bound,
                "quad0": quad0, "T0": T0,
                "draws": {k: torch.stack([d[k] for d in draws]) for k in draws[0]}}

    def solve_packed(self, inputs: Dict[str, Any]) -> torch.Tensor:
        """``track_adam`` of ``solve_inputs``'s tree, packed: what the CUDA
        graph captures."""
        frame = {k: inputs[k] for k in ("params", "enc_feats", "refer_w2c", "colorf",
                                        "depthf", "labelf", "bound")}
        d = inputs["draws"]
        best, _ = self.track_adam(frame, inputs["quad0"], inputs["T0"],
                                  lambda i: {k: v[i] for k, v in d.items()})
        return self._pack(best)

    def _replay(self, inputs: Dict[str, Any]) -> torch.Tensor:
        """The packed result of the captured solve on ``inputs`` (captured
        first, over new buffers, where no graph fits their shapes)."""
        dev = inputs["quad0"].device
        given = graphs.leaves(inputs)
        key = graphs.shapes_key(dev, given)
        if self._graph is None or self._graph[0] != key:
            self._graph = None  # free the old graph's pool before the new capture
            static = graphs.clone(inputs)
            solve = graphs.Piece(lambda: (self.solve_packed(static),), graphs.leaves(static),
                                 (False,), dev)
            rec = graphs.Recorder(dev, shared_pool=False)
            rec.warm_up(solve.fn)
            rec.forward(solve)
            rec.done()
            spans.count("track.graph.captures")
            self._graph = key, solve
        solve = self._graph[1]
        graphs.fill(solve.inputs, given)
        with spans.span("track.replay"):
            solve.replay("fwd")
        spans.count("track.graph.replays")
        return solve.outputs[0].clone()  # the next replay overwrites it

    def track(self, params, enc_feats, refer_w2c, color, depth, label, quad0, T0,
              bound, gen: torch.Generator, draws=None):
        """Pose solve by ``cfg.method``. Returns (the packed (10,) float32
        vector [best quad (4), best T (3), best loss, p_loss, d_loss] on
        device, n_iters_run). ``draws``: the iterations' draws (n_iters for
        Adam, lm_iters + 1 for LM, the last for the final LM evaluation);
        by default each is drawn from ``gen`` when it is needed, so the
        iterations an early exit skips draw nothing (where ``replays``, all
        n_iters are drawn ahead, as the loop would draw them)."""
        cfg = self.cfg
        dev = quad0.device
        spans.count("track.solves")
        if self.replays(dev):
            if draws is None:
                draws = self.draw_ahead(gen, dev)
            inputs = self.solve_inputs(params, enc_feats, refer_w2c, color, depth, label,
                                       quad0, T0, bound, draws)
            return self._replay(inputs), cfg.n_iters
        frame = {"params": params, "enc_feats": enc_feats, "refer_w2c": refer_w2c,
                 "colorf": color.reshape(-1, 3), "depthf": depth.reshape(-1),
                 "labelf": label.reshape(-1), "bound": bound}
        if draws is None:
            draw = lambda _: self.draw(gen, dev)
        else:
            draw = lambda i: draws[i]
        solve = self.track_adam if cfg.method == "adam" else self.track_lm
        best, n_run = solve(frame, quad0, T0, draw)
        return self._pack(best), n_run


def pose_init_const_velocity(est_c2w_list: np.ndarray, idx: int,
                             const_speed: bool = True) -> np.ndarray:
    """Constant-velocity pose initialisation."""
    pre = est_c2w_list[idx - 1]
    if const_speed and idx > 2:
        delta = pre @ np.linalg.inv(est_c2w_list[idx - 2])
        return (delta @ pre).astype(np.float32)
    return pre.astype(np.float32)
