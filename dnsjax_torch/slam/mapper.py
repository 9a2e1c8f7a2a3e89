"""Mapping keystep: joint map + keyframe-pose optimisation, PyTorch port of
dnsjax/slam/mapper.py.

One keystep call optimises a window of target frames against the map with
the 7-term loss (photometric, depth L1, semantic CE, coarse<->fine latent
distillation, TV smoothness, free space, opacity), with a fresh Adam of two
groups (map lr, BA camera lr). Window frame 0 is pose-frozen and poses move
only under BA, through ``pose_train`` gradient masks; reference-view poses
are stop-gradients.

Each iteration's random numbers come from one function, ``draw``, and the
loss takes them as input, so a test can feed dnsjax's draws to the port.

The loss (``MapLoss.compose``) is four pieces with the two grid encodes
between them; on a card ``map_step`` replays CUDA graphs of the pieces
around the eager encodes where ``replays`` holds (``slam/map_graph.py``).

``make_decoder_init_fn`` is the warm-up of new class decoders (dnsjax's
``make_decoder_init_fn``): a fresh Adam over the map's parameters (no
poses), ``n_iters`` iterations of class-restricted rays of the current
frame, features from that one view. Its loss is not the keystep's: depth
L1 without the variance weighting, no distillation term, and the TV term
on every iteration, unscaled (``smooth_every`` does not apply).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from dnsjax_torch import spans
from dnsjax_torch.geometry.rays import project_points, ray_box_far, rays_from_uv, world_to_camera
from dnsjax_torch.geometry.se3 import compose_c2w, invert_se3, quat_to_rotation
from dnsjax_torch.losses.losses import (
    depth_l1_loss,
    freespace_opacity_loss,
    latent_distill_loss,
    photometric_loss,
    semantic_ce_loss,
    tv_smoothness_loss,
)
from dnsjax_torch.models.decoder import (
    DecoderSpec,
    blob_encode,
    coarse_apply,
    grid_encode,
    param_leaves,
)
from dnsjax_torch.models.features import match_features, match_features_batched
from dnsjax_torch.ops.oneblob import linspace01
from dnsjax_torch.render.pipeline import normalize_pts, render_fine, render_fine_encoded
from dnsjax_torch.render.sampling import draw_z_noise, sample_along_rays
from dnsjax_torch.slam.graphs import capturable
from dnsjax_torch.slam.map_graph import MapGraphs
from dnsjax_torch.slam.sampling import (
    sample_class_balanced_pixels,
    sample_restricted_class_pixels,
    sample_uniform_pixels,
)


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


def smoothness_grid_occ(params, spec, pts01, grid, cfg: MapConfig, compute_dtype):
    """Occupancy logits on the TV sub-grid, (g, g, g), from its points and
    their grid features."""
    g = cfg.smooth_pts - 1
    occ = coarse_apply(params, blob_encode(pts01, spec), grid, compute_dtype)[:, 0]
    return occ.reshape(g, g, g)


def smoothness_loss(params, spec, bound: torch.Tensor, draws, cfg: MapConfig, compute_dtype):
    """The TV term on the sub-grid that ``draws`` place, in the ``map.smooth``
    span; the counter ``map.smooth.points`` adds its points."""
    with spans.span("map.smooth"):
        p01 = smoothness_grid_pts01(bound, draws["sm_offset"], draws["sm_jitter"], cfg)
        spans.count("map.smooth.points", p01.shape[0])
        grid = grid_encode(params, p01, spec)
        return tv_smoothness_loss(smoothness_grid_occ(params, spec, p01, grid, cfg, compute_dtype))


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

    def draw(self, gen: torch.Generator, window: Dict[str, Any], it: int) -> Dict[str, Any]:
        """All random numbers of iteration ``it``: per target frame 2/3
        uniform + 1/3 class-balanced pixels and the z-sampling uniforms;
        the TV sub-grid placement on the iterations that evaluate it."""
        cfg, T, dev = self.cfg, self.T, window["colors"].device
        pix_u = sample_uniform_pixels(gen, self.n_uni, cfg.H, cfg.W, batch=(T,), device=dev)
        u = torch.rand((T, self.n_bal), generator=gen, device=dev)
        pix_b = sample_class_balanced_pixels(u, window["sorted_idx"], window["offsets"])
        t_surf, t_zero = draw_z_noise(gen, (T,), cfg.n_surface, dev)
        d = {"pix": torch.cat([pix_u, pix_b], -1), "t_surf": t_surf, "t_zero": t_zero}
        if self.smooth_iter(it):
            d["sm_offset"] = torch.rand(3, generator=gen, device=dev)
            d["sm_jitter"] = torch.rand(3, generator=gen, device=dev)
        return d

    def lambda_lt(self, window, it: int) -> float:
        """The distillation term's weight at iteration ``it``: 0 while
        ``it <= lt_gate_iter``."""
        return 10.0 if it > int(window["lt_gate_iter"]) else 0.0

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

    # The iteration's four pieces, which the grid encodes separate. Each
    # takes and returns tensors only; ``slam/map_graph.py`` captures each as
    # CUDA graphs and replays them under the same names.
    def rays(self, params, quads, Ts, window, draws):
        """Piece (a): poses, rays, z values, points and their merged pixel
        codes; (pts01 (N*S, 3) the points in [0,1]^3, code (N, S, h), z,
        gt_c, gt_d, gt_l, mask) for the N = T * n_ray rays."""
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
        mask = inside
        if "frame_valid" in window:
            mask = mask & (torch.repeat_interleave(window["frame_valid"], n_ray) > 0)
        pts01 = normalize_pts(pts, window["bound"]).reshape(T * n_ray * S, 3)
        return pts01, code, z, gt_c, gt_d, gt_l, mask

    def ray_terms(self, params, pts01, grid, code, z, gt_c, gt_d, gt_l, mask):
        """Piece (b), after the rays' encode (``grid``): the fine render and
        the six ray terms (p, d, l, lt, fs, op)."""
        cfg = self.cfg
        out = render_fine_encoded(params, self.spec, pts01, grid, z, gt_l, code, self.dtype)
        p_loss = photometric_loss(gt_c, out.color, mask)
        d_loss = depth_l1_loss(gt_d, out.depth, mask)
        l_loss = semantic_ce_loss(gt_l, out.logits, mask)
        lt_loss = latent_distill_loss(out.coarse_latents, out.fine_latents, mask[:, None, None])
        fs_loss, op_loss = freespace_opacity_loss(
            z, gt_d, out.fine_latents[..., 0], mask,
            truncation=cfg.truncation, sigma=cfg.opacity_sigma,
        )
        return p_loss, d_loss, l_loss, lt_loss, fs_loss, op_loss

    def smooth_points(self, bound, draws):
        """Piece (c): the TV sub-grid's points in [0,1]^3."""
        return smoothness_grid_pts01(bound, draws["sm_offset"], draws["sm_jitter"], self.cfg)

    def smooth_total(self, params, p01, grid, terms, lambda_lt):
        """Piece (d), after the TV encode (``grid``): the TV term (scaled by
        ``smooth_every``) and the weighted sum of the seven terms;
        (loss, sm_loss)."""
        occ = smoothness_grid_occ(params, self.spec, p01, grid, self.cfg, self.dtype)
        sm_loss = tv_smoothness_loss(occ) * float(max(self.cfg.smooth_every, 1))
        return self.weighted(terms, sm_loss, lambda_lt), sm_loss

    def weighted(self, terms, sm_loss, lambda_lt):
        """The loss: the seven terms' weighted sum."""
        cfg = self.cfg
        p_loss, d_loss, l_loss, lt_loss, fs_loss, op_loss = terms
        return (
            cfg.lambda_p * p_loss + cfg.lambda_d * d_loss + cfg.lambda_l * l_loss
            + lambda_lt * lt_loss + cfg.lambda_sm * sm_loss
            + cfg.lambda_fs * fs_loss + cfg.lambda_op * op_loss
        )

    def compose(self, pieces, params, quads, Ts, window, draws, smooth: bool, lambda_lt):
        """(loss, the seven terms) from the four pieces of ``pieces`` (this
        loss's own, or ``map_graph.Pieces``' replays of them, which read
        their own copies of ``window`` and ``draws``) and the grid encodes
        between them, in this order; the TV term's points, encode and
        piece (d) in the ``map.smooth`` span, when ``smooth``."""
        pts01, code, z, gt_c, gt_d, gt_l, mask = pieces.rays(params, quads, Ts, window, draws)
        grid = grid_encode(params, pts01, self.spec)
        terms = pieces.ray_terms(params, pts01, grid, code, z, gt_c, gt_d, gt_l, mask)
        if smooth:
            with spans.span("map.smooth"):
                p01 = pieces.smooth_points(window["bound"], draws)
                spans.count("map.smooth.points", p01.shape[0])
                loss, sm_loss = pieces.smooth_total(
                    params, p01, grid_encode(params, p01, self.spec), terms, lambda_lt)
        else:
            sm_loss = torch.zeros((), device=z.device)
            loss = self.weighted(terms, sm_loss, lambda_lt)
        p_loss, d_loss, l_loss, lt_loss, fs_loss, op_loss = terms
        aux = {"p_loss": p_loss, "d_loss": d_loss, "l_loss": l_loss,
               "lt_loss": lt_loss, "sm_loss": sm_loss, "fs_loss": fs_loss,
               "op_loss": op_loss}
        return loss, aux

    def __call__(self, params, quads, Ts, window, draws, it: int):
        return self.compose(self, params, quads, Ts, window, draws, self.smooth_iter(it),
                            self.lambda_lt(window, it))


def make_optimizer(params, quads: torch.Tensor, Ts: torch.Tensor, cfg: MapConfig):
    """A fresh Adam with two groups: the map at ``lr`` and the window poses
    at ``ba_cam_lr`` (optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(
        [{"params": param_leaves(params), "lr": cfg.lr},
         {"params": [quads, Ts], "lr": cfg.ba_cam_lr}],
        betas=(0.9, 0.999), eps=1e-8,
    )


class DecoderInitLoss:
    """The warm-up loss on ``n_pixels`` class-restricted rays of one frame.

    Frame dict (tensors on the compute device): color (H,W,3), depth (H,W),
    label (H,W), c2w (4,4), bound (3,2), sorted_idx (H*W,), offsets (C+1,),
    feats (1,Hf,Wf,64) the frame's encoder features.
    """

    def __init__(self, spec: DecoderSpec, cfg: MapConfig, n_pixels: int = 300,
                 compute_dtype=torch.bfloat16):
        self.spec, self.cfg, self.n, self.dtype = spec, cfg, n_pixels, compute_dtype
        self.S = cfg.n_samples + cfg.n_surface

    def draw(self, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """One iteration's random numbers: the restricted sampler's uniforms,
        the z-sampling uniforms and the TV sub-grid placement."""
        t_surf, t_zero = draw_z_noise(gen, (), self.cfg.n_surface, device)
        return {"u": torch.rand(self.n, generator=gen, device=device),
                "t_surf": t_surf, "t_zero": t_zero,
                "sm_offset": torch.rand(3, generator=gen, device=device),
                "sm_jitter": torch.rand(3, generator=gen, device=device)}

    def __call__(self, params, frame, class_mask, draws) -> torch.Tensor:
        cfg, spec, bound = self.cfg, self.spec, frame["bound"]
        pix = sample_restricted_class_pixels(draws["u"], frame["sorted_idx"], frame["offsets"],
                                             class_mask)
        gt_c = frame["color"].reshape(-1, 3)[pix]
        gt_d = frame["depth"].reshape(-1)[pix]
        gt_l = frame["label"].reshape(-1)[pix]
        i = (pix % cfg.W).to(torch.float32)
        j = (pix // cfg.W).to(torch.float32)
        rays_o, rays_d = rays_from_uv(i, j, frame["c2w"], cfg.fx, cfg.fy, cfg.cx, cfg.cy)
        far = ray_box_far(rays_o, rays_d, bound)
        inside = far >= gt_d
        z = sample_along_rays(gt_d, cfg.n_samples, cfg.n_surface, far + 0.01,
                              draws["t_surf"], draws["t_zero"])
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        code = match_features(
            params, pts.reshape(-1, 3), invert_se3(frame["c2w"])[None], frame["feats"],
            cfg.cam, bound, spec, self.dtype, taps=cfg.feature_taps,
        ).reshape(self.n, self.S, -1)
        dd = gt_d[:, None]
        trunc = (z >= dd * 0.95) & (z <= dd * 1.05) & (dd > 0)
        out = render_fine(params, spec, pts, z, gt_l, code * trunc[..., None], bound, self.dtype)
        mask = (gt_d > 0.01) & inside
        p_loss = photometric_loss(gt_c, out.color, mask)
        d_loss = depth_l1_loss(gt_d, out.depth, mask)
        l_loss = semantic_ce_loss(gt_l, out.logits, mask)
        sm_loss = smoothness_loss(params, spec, bound, draws, cfg, self.dtype)
        fs_loss, op_loss = freespace_opacity_loss(
            z, gt_d, out.fine_latents[..., 0], mask,
            truncation=cfg.truncation, sigma=cfg.opacity_sigma,
        )
        return (
            cfg.lambda_p * p_loss + cfg.lambda_d * d_loss + cfg.lambda_l * l_loss
            + cfg.lambda_fs * fs_loss + cfg.lambda_op * op_loss + cfg.lambda_sm * sm_loss
        )


def make_decoder_init_fn(spec: DecoderSpec, cfg: MapConfig, n_iters: int = 100,
                         n_pixels: int = 300, compute_dtype=torch.bfloat16):
    """The decoder warm-up: ``fn(params, frame, class_mask, gen, draws=None)
    -> losses (n_iters,)`` on device, updating ``params`` in place with a
    fresh Adam at ``cfg.lr`` (optax.adam's defaults). ``draws``: the
    iterations' draws (default: from ``gen``)."""
    loss_fn = DecoderInitLoss(spec, cfg, n_pixels, compute_dtype)

    def fn(params, frame, class_mask, gen, draws=None):
        leaves = param_leaves(params)
        opt = torch.optim.Adam(leaves, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        losses: List[torch.Tensor] = []
        for p in leaves:
            p.requires_grad_(True)
        try:
            for it in range(n_iters):
                with spans.span("map.iter"):
                    d = (draws[it] if draws is not None
                         else loss_fn.draw(gen, frame["color"].device))
                    opt.zero_grad(set_to_none=True)
                    loss = loss_fn(params, frame, class_mask, d)
                    loss.backward()
                    with spans.span("map.adam"):
                        opt.step()
                    losses.append(loss.detach())
        finally:
            for p in leaves:
                p.requires_grad_(False)
                p.grad = None
        return torch.stack(losses)

    fn.loss_fn = loss_fn
    return fn


def replays(cfg: MapConfig, device, reduce=None) -> bool:
    """Does ``map_step`` replay the iteration's captured pieces
    (``slam/map_graph.py``)? Where ``capturable`` (``slam/graphs.py``),
    without a ``reduce`` (no ray mesh) and with the TV term on every
    iteration, so that every iteration runs the same program."""
    return reduce is None and cfg.smooth_every <= 1 and capturable(device)


def map_step(loss_fn: MapLoss, params, quads0, Ts0, window, gen: torch.Generator,
             n_iters: int, reduce=None, draws=None, graphs=None):
    """Run ``n_iters`` optimisation iterations with a fresh Adam.

    Updates ``params`` in place; returns (quads, Ts, aux) where aux holds
    the last iteration's loss terms and ``losses`` (n_iters,) on device.
    Pose gradients are masked by ``pose_train`` before each Adam update, so
    frozen poses carry zero gradients (and so never move), as in optax.
    ``reduce``: under a mesh, ``reduce(values, grads) -> (values, grads)``
    combines the iteration's [loss, loss terms...] and [map gradients
    (table first)..., quads gradient, Ts gradient] over the ranks before
    each update (``parallel/mesh.py``). ``draws``: each iteration's draws
    (default: from ``gen``). ``graphs``: a ``map_graph.MapGraphs`` whose
    captured pieces the iterations replay where ``replays`` says so (all
    ``n_iters`` draws are then taken ahead, in the order the loop takes
    them); else, and without it, the loop runs uncaptured. The counters
    ``map.iters`` and ``map.graph.replays`` add each iteration, and each
    that replayed.
    """
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    pieces = None
    if graphs is not None and replays(loss_fn.cfg, quads0.device, reduce):
        if draws is None:
            draws = [loss_fn.draw(gen, window, it) for it in range(n_iters)]
        pieces = graphs.pieces_for(loss_fn, params, quads0, Ts0, window, draws)
        quads, Ts = pieces.quads, pieces.Ts  # holding quads0, Ts0
    else:
        quads = quads0.detach().clone().requires_grad_(True)
        Ts = Ts0.detach().clone().requires_grad_(True)
    opt = make_optimizer(params, quads, Ts, loss_fn.cfg)
    pose_train = window["pose_train"][:, None]
    losses: List[torch.Tensor] = []
    aux = None
    try:
        for it in range(n_iters):
            with spans.span("map.iter"):
                opt.zero_grad(set_to_none=True)
                if pieces is None:
                    d = draws[it] if draws is not None else loss_fn.draw(gen, window, it)
                    loss, aux = loss_fn(params, quads, Ts, window, d, it)
                else:
                    loss, aux = pieces.iteration(it)
                loss.backward()
                if reduce is not None:
                    loss, aux = _reduce_step(reduce, loss, aux, leaves + [quads, Ts])
                quads.grad.mul_(pose_train)
                Ts.grad.mul_(pose_train)
                with spans.span("map.adam"):
                    opt.step()
                losses.append(loss.detach().clone())  # a replay's loss: the graph's buffer
                spans.count("map.iters")
                if pieces is not None:
                    spans.count("map.graph.replays")
    finally:
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None
        quads.grad = Ts.grad = None
    aux = {k: v.detach().clone() for k, v in aux.items()}
    aux["losses"] = torch.stack(losses)
    return quads.detach().clone(), Ts.detach().clone(), aux


def _reduce_step(reduce, loss, aux, leaves):
    """Combine one iteration's loss, loss terms and gradients (written back
    into each leaf's ``.grad``) over the ranks with ``reduce``."""
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    keys = list(aux)
    values, grads = reduce([loss.detach()] + [aux[k].detach() for k in keys],
                           [p.grad for p in leaves])
    for p, g in zip(leaves, grads):
        p.grad.copy_(g)
    return values[0], dict(zip(keys, values[1:]))


def overlap_scores(depth, c2w, kf_est_c2w, kf_valid, pix, cfg: MapConfig,
                   n_samples: int = 16) -> torch.Tensor:
    """Keyframe overlap ranking: lift ``n_samples`` depth-bracketed points on
    each sampled pixel ``pix`` (n,) of the current view, project into every
    keyframe and score by the fraction inside its frustum; -1 where invalid."""
    gt_d = depth.reshape(-1)[pix]
    i = (pix % cfg.W).to(torch.float32)
    j = (pix // cfg.W).to(torch.float32)
    rays_o, rays_d = rays_from_uv(i, j, c2w, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    t = linspace01(n_samples, depth.device)
    near = gt_d[:, None] * 0.8
    far = gt_d[:, None] + 0.5
    z = near * (1 - t[None]) + far * t[None]
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    cam_pts = world_to_camera(pts, invert_se3(kf_est_c2w))
    u, v, d = project_points(cam_pts, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    edge = 10
    ok = (u > edge) & (u < cfg.W - edge) & (v > edge) & (v < cfg.H - edge) & (d > 0)
    score = ok.to(torch.float32).mean(1)
    return torch.where(kf_valid, score, torch.full_like(score, -1.0))


def _build_loss_fn(spec: DecoderSpec, cfg: MapConfig, n_target: int,
                   compute_dtype=torch.bfloat16) -> MapLoss:
    """The mapping loss for a window of ``n_target`` frames (see MapLoss)."""
    return MapLoss(spec, cfg, n_target, compute_dtype)


def make_map_fn(spec: DecoderSpec, cfg: MapConfig, n_target: int, n_iters: int,
                compute_dtype=torch.bfloat16):
    """The keystep for a window of ``n_target`` frames:
    ``fn(params, quads0, Ts0, window, gen, draws=None) -> (quads, Ts,
    aux)``, updating ``params`` in place (``draws``: see ``map_step``). It
    keeps its own captured pieces (``fn.graphs``) where ``replays``."""
    loss_fn = _build_loss_fn(spec, cfg, n_target, compute_dtype)
    graphs = MapGraphs()

    def fn(params, quads0, Ts0, window, gen, draws=None):
        return map_step(loss_fn, params, quads0, Ts0, window, gen, n_iters, draws=draws,
                        graphs=graphs)

    fn.loss_fn, fn.graphs = loss_fn, graphs
    return fn


def make_overlap_score_fn(cfg: MapConfig, n_pixels: int = 100, n_samples: int = 16):
    """``fn(depth, c2w, kf_est_c2w, kf_valid, gen) -> (K,) scores`` drawing
    ``n_pixels`` uniform pixels of the current view from ``gen``."""

    def fn(depth, c2w, kf_est_c2w, kf_valid, gen):
        pix = sample_uniform_pixels(gen, n_pixels, cfg.H, cfg.W, device=depth.device)
        return overlap_scores(depth, c2w, kf_est_c2w, kf_valid, pix, cfg, n_samples)

    return fn
