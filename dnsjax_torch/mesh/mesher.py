"""Mesh extraction, PyTorch port of dnsjax/mesh/mesher.py: a chunked field
query on the device, marching tetrahedra and cleanup on the host.

A lattice over the marching-cubes bound (+0.05 pad) is evaluated in chunks
of ``meshing.points_batch_size`` points. Each chunk is projected into every
valid keyframe: the half-resolution feature row (nearest tap, or bilinear
with ``tpu.feature_taps: 4``), the keyframe's
depth and label, a per-view merge MLP, the mean over observing views and
the last-seen label; then the class-dispatched fine decoder (S = 1) gives
occupancy and the color head the color. Out-of-bound points get occupancy
-100 and label -1. The hierarchical query evaluates a half-resolution
lattice first and refines only cells that may cross the level set.

dnsjax scans every keyframe slot with ``lax.scan`` and skips a view with
``lax.cond``; here the loop runs over valid slots only, and one batched
test per chunk decides which views may see it (one host read per chunk).
Both are exact: every contribution is gated by ``valid`` and by the same
``seen`` predicate the test bounds. Chunk results come back through pinned
host buffers with non-blocking copies, one chunk behind the device.

Host code (lattice, Morton order, refinement flags, marching, cleaning,
vertex attributes) is numpy, as in dnsjax; marching (``mesh/marching.py``,
native library first) and the PLY writer (``mesh/export.py``) are the
port's own copies of dnsjax's.

Options, as dnsjax's: ``meshing.depth_test`` drops a view where the point
lies more than 0.5 m behind the keyframe's depth, and with
``use_est_depth`` the keyframes' missing depth is first rendered from the
coarse field (``estimated_depths``, through the encode kernel);
``show_forecast`` gives never-observed points the coarse field's occupancy
and crops the mesh to the scaled hull of the keyframes' depth clouds
(``frames_hull``); ``get_mask_use_all_frames`` also keeps a vertex that any
pose of the trajectory frames (``_frustum_any``).

Under a ray mesh (``device_mesh=``, ``parallel/mesh.py:RayMesh``) each chunk
of ``points_batch_size`` points (rounded up to split evenly) is queried in
equal shares, one per rank, and gathered by one all-reduce; every rank then
holds the whole chunk's results and runs the same host code, as dnsjax's
``shard_map`` over chunk points does.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from dnsjax_torch.geometry.rays import project_points, ray_box_far, rays_from_uv, world_to_camera
from dnsjax_torch.geometry.se3 import invert_se3
from dnsjax_torch.mesh.export import write_ply
from dnsjax_torch.mesh.marching import marching_tetrahedra
from dnsjax_torch.models.decoder import (
    DecoderSpec,
    coarse_apply,
    fine_apply,
    merge_apply,
    pos_encode,
)
from dnsjax_torch.models.encoder import encode_images
from dnsjax_torch.models.features import _row_gather, bilinear_sample, nearest_sample
from dnsjax_torch.ops.mlp import mlp_apply
from dnsjax_torch.render.composite import composite_rays
from dnsjax_torch.render.sampling import sample_along_rays

EST_DEPTH_SAMPLES = 32  # stratified samples a ray of estimated_depths (dnsjax's)


def class_palette(n_class: int) -> np.ndarray:
    """Semantic class -> display color (uint8 RGB), dnsjax's fixed palette."""
    return np.random.default_rng(7).integers(0, 256, size=(max(n_class, 1), 3)).astype(np.uint8)


class _Views(NamedTuple):
    """Per-keyframe inputs of a query, prepared once per extraction."""
    c2w: torch.Tensor            # (K, 4, 4)
    w2c: torch.Tensor            # (K, 4, 4)
    valid: torch.Tensor          # (K,) bool
    maps: torch.Tensor           # (K, Hf, Wf, C [+ 2 fused]) compute dtype
    depth_label: Optional[torch.Tensor]  # (K, H, W, 2) float32, separate rows only


class Mesher:
    def __init__(self, cfg: Dict[str, Any], cam: Dict[str, Any], bound: np.ndarray,
                 spec: DecoderSpec, compute_dtype=torch.bfloat16, device_mesh=None):
        m = cfg["meshing"]
        tpu = cfg.get("tpu", {}) or {}
        self.resolution = int(m.get("resolution", 256))
        self.points_batch = int(m.get("points_batch_size", 262144))
        self.level_set = float(m.get("level_set", 0.0))
        self.clean_mesh = bool(m.get("clean_mesh", True))
        self.vertex_attr = str(m.get("vertex_attr", "interpolate"))
        self.hierarchical = bool(m.get("hierarchical", True))
        self.get_largest = bool(m.get("get_largest_components", False))
        self.small_thresh = float(m.get("remove_small_geometry_threshold", 0.2))
        self.color = bool(m.get("color", True))
        self.label = bool(m.get("label", True))
        self.element = bool(m.get("element", False))
        self.depth_test = bool(m.get("depth_test", False))
        self.use_est_depth = bool(m.get("use_est_depth", False))
        self.show_forecast = bool(m.get("show_forecast", False))
        self.bound_scale = float(m.get("clean_mesh_bound_scale", 1.02))
        self.mask_all_frames = bool(m.get("get_mask_use_all_frames", False))
        # feature taps as in training (tpu.feature_taps): 1 nearest, 4 bilinear
        self.feature_taps = int(tpu.get("feature_taps", 4))
        # fused view rows: [feats | depth | label] in one half-res bf16 map
        # per keyframe, one gather row per view-point (see fuse_view_maps);
        # they hold one tap, so 4 taps take the separate gathers, as in dnsjax
        self.fuse_rows = bool(tpu.get("mesh_fused_rows", self.feature_taps == 1))
        if self.fuse_rows and self.feature_taps != 1:
            warnings.warn("tpu.mesh_fused_rows=true requires tpu.feature_taps=1 "
                          f"(got {self.feature_taps}); using separate full-res gathers "
                          "instead", stacklevel=2)
            self.fuse_rows = False
        # skip views whose frustum provably sees no point of the chunk
        self.view_skip = bool(tpu.get("mesh_view_skip", True))
        scale = float(cfg.get("scale", 1))
        self.mc_bound = np.asarray(
            cfg["back_end"].get("marching_cubes_bound", cfg["back_end"]["bound"]),
            np.float64) * scale
        self.bound = np.asarray(bound, np.float64)
        self.cam = cam
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.device_mesh = device_mesh
        if device_mesh is not None:
            n = device_mesh.size  # the chunk must split evenly over the ranks
            self.points_batch = -(-self.points_batch // n) * n
        self.last_timings: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def fuse_view_maps(self, feats: torch.Tensor, depths: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
        """Pack per-keyframe [feats | depth | label] into one half-res bf16
        map (K, Hf, Wf, C+2); depth and label nearest-sampled at the
        half-res grid positions of the query's align_corners mapping."""
        K, Hf, Wf = feats.shape[0], feats.shape[1], feats.shape[2]
        H, W = int(self.cam["H"]), int(self.cam["W"])
        dev = feats.device
        yi = torch.round(torch.arange(Hf, dtype=torch.float32, device=dev)
                         * ((H - 1.0) / (Hf - 1.0))).to(torch.int64)
        xi = torch.round(torch.arange(Wf, dtype=torch.float32, device=dev)
                         * ((W - 1.0) / (Wf - 1.0))).to(torch.int64)
        d_half = depths[:, yi][:, :, xi]
        l_half = labels[:, yi][:, :, xi].to(torch.float32)
        bf = torch.bfloat16
        return torch.cat([feats.to(bf), d_half[..., None].to(bf), l_half[..., None].to(bf)], -1)

    def _views(self, kf_c2w, kf_valid, kf_feats, kf_labels, kf_depths) -> _Views:
        """kf_feats: the fused maps when ``fuse_rows``, else the encoder maps."""
        c2w = kf_c2w.to(torch.float32)
        dl = None
        if not self.fuse_rows:
            dl = torch.stack([kf_depths, kf_labels.to(kf_depths.dtype)], -1)
        return _Views(c2w, invert_se3(c2w), kf_valid.to(torch.bool), kf_feats, dl)

    def query_chunk(self, params, pts, kf_c2w, kf_valid, kf_feats, kf_labels,
                    kf_depths, bound):
        """dnsjax's signature: pts (B, 3) -> occ (B,), label (B,), color
        (B, 3), count (B,) of observing views."""
        views = self._views(kf_c2w, kf_valid, kf_feats, kf_labels, kf_depths)
        packed = self._query_packed(params, pts, views, bound)
        return packed[:, 0], packed[:, 1].to(torch.int32), packed[:, 2:5], packed[:, 5]

    def _query_packed(self, params, pts: torch.Tensor, views: _Views, bound: torch.Tensor):
        """(B, 6) float32 [occ, label, rgb, count] of the B points; under a
        ray mesh each rank queries its share of the rows and the chunk is
        gathered."""
        mesh = self.device_mesh
        local = pts
        if mesh is not None:
            a, b = mesh.rows(pts.shape[0])
            local = pts[a:b]
        o, lab, c, cnt = self._query(params, local, views, bound)
        packed = torch.cat([o[:, None], lab.to(torch.float32)[:, None], c, cnt[:, None]], -1)
        return packed if mesh is None else mesh.gather_rows(packed, pts.shape[0])

    def _visible(self, pts: torch.Tensor, views: _Views) -> List[bool]:
        """Per view: may any chunk point satisfy ``seen``? With every corner
        of the chunk's AABB in front of the camera, the projected hull is
        the hull of the projected corners, so corners all beyond one image
        edge prove the view sees nothing; a corner behind the camera voids
        that argument (unless all are behind). One host read."""
        cam = self.cam
        if not self.view_skip:
            return views.valid.tolist()
        lo, hi = pts.amin(0), pts.amax(0)
        cbits = torch.tensor([[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
                             dtype=pts.dtype, device=pts.device)
        aabb = lo[None] * (1 - cbits) + hi[None] * cbits  # (8, 3)
        uc, vc, dc = project_points(world_to_camera(aabb, views.w2c),
                                    cam["fx"], cam["fy"], cam["cx"], cam["cy"])  # (K, 8)
        all_behind = (dc <= 0).all(-1)
        sep = ((uc <= 0).all(-1) | (uc >= cam["W"] - 1).all(-1)
               | (vc <= 0).all(-1) | (vc >= cam["H"] - 1).all(-1))
        return (views.valid & ~all_behind & ((dc <= 0).any(-1) | ~sep)).tolist()

    def _query(self, params, pts: torch.Tensor, views: _Views, bound: torch.Tensor):
        spec, cam, cdt = self.spec, self.cam, self.compute_dtype
        B, dev = pts.shape[0], pts.device
        W, H = cam["W"], cam["H"]
        code_sum = torch.zeros((B, spec.hidden_dim), device=dev)
        count = torch.zeros((B,), device=dev)
        label = torch.zeros((B,), dtype=torch.int32, device=dev)
        label_seen = torch.zeros((B,), dtype=torch.bool, device=dev)
        for k, maybe in enumerate(self._visible(pts, views)):
            if not maybe:
                continue
            pc = world_to_camera(pts, views.w2c[k][None])[0]
            u, v, d = project_points(pc, cam["fx"], cam["fy"], cam["cx"], cam["cy"])
            u = torch.round(u)
            v = torch.round(v)
            seen = (u > 0) & (u < W - 1) & (v > 0) & (v < H - 1) & (d > 0)
            maps = views.maps[k]
            Hf, Wf = maps.shape[0], maps.shape[1]
            gx = u * ((Wf - 1.0) / (W - 1.0))
            gy = v * ((Hf - 1.0) / (H - 1.0))
            if self.fuse_rows:
                row = nearest_sample(maps, gx, gy)  # (B, C + 2)
                code = row[:, :-2]
                kf_d = row[:, -2].to(torch.float32)
                lab_f = row[:, -1].to(torch.float32)
            else:
                sampler = bilinear_sample if self.feature_taps == 4 else nearest_sample
                code = sampler(maps, gx, gy)
                ui = torch.clamp(u, 0, W - 1).to(torch.int64)
                vi = torch.clamp(v, 0, H - 1).to(torch.int64)
                dl = _row_gather(views.depth_label[k], vi, ui)  # (B, 2)
                kf_d, lab_f = dl[:, 0], dl[:, 1]
            if self.depth_test:
                seen = seen & ((kf_d <= 0) | (d <= kf_d + 0.5))
            trunc = (d > kf_d * 0.95) & (d < kf_d * 1.05) & (kf_d > 0)
            code = code * (seen & trunc)[:, None]
            rel = pts - views.c2w[k, :3, 3]
            merged = merge_apply(params, rel[None], code[None], bound, spec, cdt)
            code_sum = code_sum + merged * seen[:, None]
            count = count + seen.to(torch.float32)
            label = torch.where(seen, lab_f.to(torch.int32), label)
            label_seen = label_seen | seen
        code = code_sum / torch.clamp(count, min=1.0)[:, None]

        p01 = (pts - bound[:, 0]) / (bound[:, 1] - bound[:, 0])
        in_bound = ((p01 >= 0) & (p01 <= 1)).all(-1)
        pe, grid = pos_encode(params, torch.clamp(p01, 0, 1), spec)
        lat = fine_apply(params, label, pe[:, None, :], grid[:, None, :], cdt)[:, 0]
        occ = lat[:, 0]
        if self.show_forecast:
            # never-observed points take the class-agnostic coarse field
            occ = torch.where(label_seen, occ, coarse_apply(params, pe, grid, cdt)[:, 0])
        occ = torch.where(in_bound, occ, torch.full_like(occ, -100.0))
        color = torch.sigmoid(mlp_apply(params["color"], torch.cat([pe, lat[:, 1:], code], -1),
                                        cdt))
        out_label = torch.where(in_bound & label_seen, label, torch.full_like(label, -1))
        return occ, out_label, color, count

    # ------------------------------------------------------------------
    def _grid_axes(self):
        """Per-axis lattice coordinates (float64), origin and spacing."""
        pad = 0.05
        lo = self.mc_bound[:, 0] - pad
        hi = self.mc_bound[:, 1] + pad
        r = self.resolution
        axes = [np.linspace(lo[k], hi[k], r) for k in range(3)]
        spacing = [(hi[k] - lo[k]) / (r - 1) for k in range(3)]
        return axes, lo, spacing

    def _all_rays(self, c2w: torch.Tensor):
        """(H, W, 3) ray origins and directions of every pixel under ``c2w``."""
        H, W = int(self.cam["H"]), int(self.cam["W"])
        j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=c2w.device),
                              torch.arange(W, dtype=torch.float32, device=c2w.device),
                              indexing="ij")
        return rays_from_uv(i, j, c2w, self.cam["fx"], self.cam["fy"], self.cam["cx"],
                            self.cam["cy"])

    def estimated_depths(self, params, keyframes, chunk: int = 8192) -> torch.Tensor:
        """(capacity, H, W) keyframe depths with each valid slot's zero-depth
        pixels filled by depth rendered from the coarse field (32 stratified
        samples a ray, no random draws), in chunks of ``chunk`` rays;
        dnsjax's ``estimated_depths`` (active under depth_test +
        use_est_depth)."""
        spec, cdt = self.spec, self.compute_dtype
        kf = keyframes
        bound = torch.as_tensor(self.bound, dtype=torch.float32, device=kf.depths.device)
        none = torch.empty(0, device=bound.device)
        out = []
        for k in range(kf.count):
            o, d = self._all_rays(kf.est_c2w[k])
            o, d = o.reshape(-1, 3), d.reshape(-1, 3)
            df = kf.depths[k].reshape(-1)
            far = ray_box_far(o, d, bound) + 0.01
            z = sample_along_rays(df, EST_DEPTH_SAMPLES, 0, far, none, none)
            est = []
            for a in range(0, df.shape[0], chunk):
                zc = z[a:a + chunk]
                pts = o[a:a + chunk, None, :] + d[a:a + chunk, None, :] * zc[..., None]
                p01 = (pts.reshape(-1, 3) - bound[:, 0]) / (bound[:, 1] - bound[:, 0])
                pe, grid = pos_encode(params, torch.clamp(p01, 0, 1), spec)
                occ = coarse_apply(params, pe, grid, cdt)[:, 0].reshape(zc.shape)
                est.append(composite_rays(torch.zeros(occ.shape + (3,), device=occ.device),
                                          occ, zc)[0])
            out.append(torch.where(df > 0, df, torch.cat(est)).reshape(kf.depths[k].shape))
        return torch.cat([torch.stack(out), kf.depths[kf.count:]]) if out else kf.depths

    def frames_hull(self, keyframes):
        """Delaunay triangulation of up to 20,000 points (``default_rng(0)``)
        of the keyframes' depth clouds (every 8th pixel each way), scaled by
        ``clean_mesh_bound_scale`` about their centroid: dnsjax's stand-in for
        the reference's TSDF-volume hull, which crops forecast geometry."""
        from scipy.spatial import Delaunay

        pts = []
        for k in range(keyframes.count):
            o, d = self._all_rays(keyframes.est_c2w[k])
            o, d = o.cpu().numpy(), d.cpu().numpy()
            dep = keyframes.depths[k].cpu().numpy()[::8, ::8]
            p = o[::8, ::8] + d[::8, ::8] * dep[..., None]
            pts.append(p.reshape(-1, 3)[dep.reshape(-1) > 0])
        cloud = np.concatenate(pts, 0)
        centroid = cloud.mean(0)
        cloud = (cloud - centroid) * self.bound_scale + centroid
        return Delaunay(cloud[np.random.default_rng(0).choice(
            cloud.shape[0], size=min(20000, cloud.shape[0]), replace=False)])

    def _frustum_any(self, verts: np.ndarray, poses: np.ndarray, device) -> np.ndarray:
        """True for the vertices inside any pose's frustum (no depth test);
        identity placeholders (untracked frames) and non-finite poses are
        skipped, 64 poses a batch."""
        cam = self.cam
        seen = torch.zeros(verts.shape[0], dtype=torch.bool, device=device)
        v = torch.as_tensor(np.asarray(verts, np.float32), device=device)
        poses = np.asarray(poses)
        is_identity = np.abs(poses - np.eye(4)).max(axis=(1, 2)) < 1e-8
        poses = poses[~is_identity & np.isfinite(poses).all((1, 2))]
        for s0 in range(0, poses.shape[0], 64):
            w2c = invert_se3(torch.as_tensor(poses[s0:s0 + 64], dtype=torch.float32,
                                             device=device))
            u, vv, d = project_points(world_to_camera(v, w2c), cam["fx"], cam["fy"],
                                      cam["cx"], cam["cy"])
            ok = (u > 0) & (u < cam["W"] - 1) & (vv > 0) & (vv < cam["H"] - 1) & (d > 0)
            seen |= ok.any(0)
        return seen.cpu().numpy()

    def _encode_views(self, params, enc_params, kf, kf_feats):
        K = kf.count
        if kf_feats is not None:
            feats = kf_feats[:K]
        else:
            feats = torch.cat([encode_images(enc_params, kf.colors[a:min(a + 8, K)],
                                             self.compute_dtype)
                               for a in range(0, max(K, 1), 8)])[:K]
        feats = feats.to(self.compute_dtype)
        depths = kf.depths
        if self.depth_test and self.use_est_depth:
            depths = self.estimated_depths(params, kf)
        depths, labels = depths[:K], kf.labels[:K]
        if self.fuse_rows:
            feats = self.fuse_view_maps(feats, depths, labels)
        valid = torch.ones((K,), dtype=torch.bool, device=feats.device)
        return self._views(kf.est_c2w[:K], valid, feats, labels, depths)

    def extract(self, params, enc_params, keyframes, class2color: Optional[np.ndarray] = None,
                all_poses: Optional[np.ndarray] = None, kf_feats=None) -> Dict[str, np.ndarray]:
        """The full extraction; returns the mesh dict (vertices, faces,
        colors, labels[, label_colors]).

        ``kf_feats``: optional encoder maps (>= count, Hf, Wf, C) the caller
        already holds (keyframe images never change after insertion).
        ``all_poses``: the trajectory's poses (N, 4, 4), read by
        ``get_mask_use_all_frames``."""
        self.last_timings = {}
        t_mark = [time.perf_counter()]

        def mark(name):
            t = time.perf_counter()
            self.last_timings[name] = self.last_timings.get(name, 0.0) + t - t_mark[0]
            t_mark[0] = t

        def add(name, value):
            self.last_timings[name] = self.last_timings.get(name, 0.0) + value

        kf = keyframes
        with torch.no_grad():
            views = self._encode_views(params, enc_params, kf, kf_feats)
        dev = views.c2w.device
        mark("encode_views")

        grid_axes, lo, spacing = self._grid_axes()
        B = self.points_batch
        interp = self.vertex_attr == "interpolate"
        bound_t = torch.as_tensor(self.bound, dtype=torch.float32, device=dev)
        cuda = dev.type == "cuda"

        def query_points(p):
            """Chunked field query: (M, 3) -> occ, label, color, seen. Points
            go in Morton order, so each chunk is compact and the view skip
            prunes; the order is a permutation (results are put back)."""
            M = p.shape[0]
            order = None
            if self.view_skip and M > B:
                t0 = time.perf_counter()
                order = self._morton_order(p, lo, spacing)
                p = p[order]
                add("morton", time.perf_counter() - t0)
            res = np.empty((M, 6), np.float32)  # occ, label, rgb, count
            bufs = [torch.empty((B, 6), pin_memory=cuda) for _ in range(2)] if cuda else None
            pending = None

            def fetch(pend):
                a, e, packed, ev, i = pend
                if ev is not None:
                    ev.synchronize()
                    packed = bufs[i]
                res[a:e] = packed[: e - a].numpy()

            for i, a in enumerate(range(0, M, B)):
                e = min(a + B, M)
                t0 = time.perf_counter()
                # pad with the chunk's last point, so padding cannot widen the
                # AABB the view skip tests
                chunk = np.broadcast_to(p[e - 1], (B, 3)).copy()
                chunk[: e - a] = p[a:e]
                with torch.no_grad():
                    packed = self._query_packed(params, torch.as_tensor(chunk, device=dev),
                                                views, bound_t)
                ev = None
                if cuda:
                    bufs[i % 2].copy_(packed, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record()
                if pending is not None:
                    fetch(pending)
                pending = (a, e, packed, ev, i % 2)
                add("query_dispatch", time.perf_counter() - t0)
                add("query_points", e - a)
                add("query_chunks", 1)
            if pending is not None:
                t0 = time.perf_counter()
                fetch(pending)
                add("query_dispatch", time.perf_counter() - t0)
            if order is not None:
                inv = np.empty(M, np.int64)
                inv[order] = np.arange(M)
                res = res[inv]
            return (res[:, 0].copy(), res[:, 1].astype(np.int32), res[:, 2:5].copy(),
                    res[:, 5].copy())

        mark("grid_setup")
        r = self.resolution
        if self.hierarchical and r >= 32:
            occ, label, col, seen = self._hierarchical_query(grid_axes, query_points)
        else:
            X, Y, Z = np.meshgrid(*grid_axes, indexing="ij")
            pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
            occ, label, col, seen = query_points(pts)
            self.last_timings["refined_share"] = 1.0
        mark("grid_query")

        verts, faces = marching_tetrahedra(occ.reshape(r, r, r), self.level_set,
                                           origin=lo, spacing=spacing)
        mark("marching")
        if verts.shape[0] == 0:
            return {"vertices": verts, "faces": faces}
        if self.clean_mesh:
            if self.show_forecast and kf.count > 0:
                inside = self.frames_hull(kf).find_simplex(verts) >= 0
                faces = faces[inside[faces].all(axis=1)]
            verts, faces = self._clean(verts, faces, seen.reshape(r, r, r), lo, spacing,
                                       all_poses, dev)
        mark("clean")

        if interp:
            # every vertex lies on a tet edge between lattice points p0 and
            # p0 + mask (mask in {0,1}^3): lerp the cached color, take the
            # nearer endpoint's label (the other one if that was never seen)
            r3 = (r,) * 3
            g = (verts - lo) / np.asarray(spacing)
            g0 = np.floor(g + 1e-4).astype(np.int64)
            frac = np.clip(g - g0, 0.0, 1.0)
            frac[frac < 1e-4] = 0.0
            t = frac.max(axis=1)
            g1 = np.minimum(g0 + (frac > 0), r - 1)
            g0 = np.clip(g0, 0, r - 1)
            f0 = np.ravel_multi_index(tuple(g0.T), r3)
            f1 = np.ravel_multi_index(tuple(g1.T), r3)
            vcol = (1.0 - t)[:, None] * col[f0] + t[:, None] * col[f1]
            near = np.where(t < 0.5, f0, f1)
            far = np.where(t < 0.5, f1, f0)
            vlab = label[near]
            miss = vlab < 0
            vlab[miss] = label[far[miss]]
        else:
            # exact re-query at each vertex, through the same chunked path
            _, vlab, vcol, _ = query_points(verts.astype(np.float32))
        mark("vertex_attrs")
        out = {"vertices": verts, "faces": faces, "colors": vcol, "labels": vlab}
        if class2color is not None:
            out["label_colors"] = class2color[np.clip(vlab, 0, len(class2color) - 1)]
        return out

    # ------------------------------------------------------------------
    _MORTON_SPREAD = None  # 1024-entry bit-spread table, built at first use

    @staticmethod
    def _morton_order(p, lo, spacing):
        """Stable argsort of points along a Morton (Z-order) curve of their
        lattice coordinates (10 bits per axis, through a spread table)."""
        if Mesher._MORTON_SPREAD is None:
            v = np.arange(1 << 10, dtype=np.uint64)
            t = np.zeros(1 << 10, np.uint64)
            for b in range(10):
                t |= ((v >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b)
            Mesher._MORTON_SPREAD = t
        t = Mesher._MORTON_SPREAD
        g = np.round((np.asarray(p) - lo) / np.asarray(spacing))
        g = np.clip(g, 0, (1 << 10) - 1).astype(np.int64)
        code = t[g[:, 0]] | (t[g[:, 1]] << np.uint64(1)) | (t[g[:, 2]] << np.uint64(2))
        return np.argsort(code, kind="stable")

    def _hierarchical_query(self, grid_axes, query_points):
        """Coarse-to-fine evaluation over the (r, r, r) lattice: every 2nd
        lattice point (plus the last plane per axis); coarse cells with a
        sign change, or a corner margin to the level below the cell's own
        spread, are refined exactly; the rest is filled by trilinear
        interpolation (occupancy, seen) and nearest coarse point (label,
        color). Returns flat occ, label, col, seen."""
        r = self.resolution
        lv = self.level_set
        ax = np.unique(np.concatenate([np.arange(0, r, 2), [r - 1]]))
        m = ax.size
        cX, cY, cZ = np.meshgrid(grid_axes[0][ax], grid_axes[1][ax], grid_axes[2][ax],
                                 indexing="ij")
        coarse_pts = np.stack([cX.ravel(), cY.ravel(), cZ.ravel()], -1).astype(np.float32)
        co, cl, cc, cs = query_points(coarse_pts)
        co3 = co.reshape(m, m, m)

        corners = np.stack([
            co3[i:m - 1 + i or None, j:m - 1 + j or None, k:m - 1 + k or None]
            for i in (0, 1) for j in (0, 1) for k in (0, 1)
        ])
        inside = corners > lv
        sign_change = inside.any(0) != inside.all(0)
        spread = corners.max(0) - corners.min(0)
        margin = np.abs(corners - lv).min(0)
        flagged = sign_change | (margin < spread)

        need = np.zeros((r, r, r), bool)
        lo_i, hi_i = ax[:-1], ax[1:]
        for a, b, c in zip(*np.nonzero(flagged)):
            need[lo_i[a]:hi_i[a] + 1, lo_i[b]:hi_i[b] + 1, lo_i[c]:hi_i[c] + 1] = True

        fc = np.interp(np.arange(r), ax, np.arange(m))
        i0 = np.minimum(fc.astype(np.int64), m - 2)
        w1 = fc - i0

        def trilerp(src):
            out = src
            for axis in range(3):
                a = np.take(out, i0, axis=axis)
                b = np.take(out, i0 + 1, axis=axis)
                shape = [1, 1, 1]
                shape[axis] = -1
                w = w1.reshape(shape)
                out = a * (1.0 - w) + b * w
            return out.astype(np.float32)

        occ = trilerp(co3)
        seen = trilerp(cs.reshape(m, m, m))
        nn = np.minimum(np.round(fc).astype(np.int64), m - 1)
        label = cl.reshape(m, m, m)[np.ix_(nn, nn, nn)]
        col = cc.reshape(m, m, m, 3)[np.ix_(nn, nn, nn)]

        where = np.nonzero(need)
        if where[0].size:
            fine_pts = np.stack([grid_axes[0][where[0]], grid_axes[1][where[1]],
                                 grid_axes[2][where[2]]], -1).astype(np.float32)
            fo, fl, fcol, fs = query_points(fine_pts)
            occ[where] = fo
            label[where] = fl
            col[where] = fcol
            seen[where] = fs
        self.last_timings["refined_share"] = where[0].size / float(r ** 3)
        return occ.reshape(-1), label.reshape(-1), col.reshape(-1, 3), seen.reshape(-1)

    def _clean(self, verts, faces, seen_grid, lo, spacing, all_poses=None, device="cpu"):
        """Drop faces with a vertex no keyframe observed (or, under
        ``get_mask_use_all_frames``, no pose of ``all_poses`` frames), then
        small components; compact the vertices."""
        idx = np.round((verts - lo) / spacing).astype(np.int64)
        idx = np.clip(idx, 0, self.resolution - 1)
        vseen = seen_grid[idx[:, 0], idx[:, 1], idx[:, 2]] > 0
        if self.mask_all_frames and all_poses is not None:
            vseen = vseen | self._frustum_any(verts, all_poses, device)
        faces = faces[vseen[faces].all(axis=1)]
        if self.get_largest or self.small_thresh > 0:
            faces = self._remove_small_components(verts, faces)
        used = np.unique(faces)
        remap = np.full(verts.shape[0], -1, np.int64)
        remap[used] = np.arange(used.size)
        return verts[used], remap[faces].astype(np.int32)

    def _remove_small_components(self, verts, faces):
        if faces.shape[0] == 0:
            return faces
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        g = coo_matrix((np.ones(e.shape[0]), (e[:, 0], e[:, 1])),
                       shape=(verts.shape[0], verts.shape[0]))
        n_comp, lab = connected_components(g, directed=False)
        sizes = np.bincount(lab, minlength=n_comp)
        if self.get_largest:
            keep_comp = [int(np.argmax(sizes))]
        else:  # drop components below small_thresh of the largest
            keep_comp = np.nonzero(sizes >= sizes.max() * self.small_thresh)[0].tolist()
        return faces[np.isin(lab[faces[:, 0]], keep_comp)]

    # ------------------------------------------------------------------
    def save_mesh(self, idx: int, out_dir: str, params, enc_params, keyframes, *,
                  class_colors: Optional[np.ndarray] = None,
                  all_poses: Optional[np.ndarray] = None, kf_feats=None,
                  write: bool = True) -> Optional[str]:
        """Driver hook: ``extract`` and write ``<out_dir>/mesh_{idx}.ply``
        (and the semantic and per-class variants); returns the path written,
        or None. ``write`` False extracts only (every rank of a ray mesh but
        the one that writes)."""
        mesh = self.extract(params, enc_params, keyframes, class_colors, all_poses=all_poses,
                            kf_feats=kf_feats)
        if not write:
            return None
        if mesh["faces"].shape[0] == 0:
            print(f"mesh_{idx}: empty")
            return None
        return write_mesh(out_dir, idx, mesh, self.color, self.label, self.element)


def write_mesh(out_dir: str, idx: int, mesh, color: bool = True, label: bool = True,
               element: bool = False) -> str:
    """``mesh_{idx}.ply`` (+ ``_semantic`` with label colors, + ``_part_{c}``
    per class when ``element``), as dnsjax writes them. Returns the path."""
    path = os.path.join(out_dir, f"mesh_{idx}.ply")
    v, f = mesh["vertices"], mesh["faces"]
    write_ply(path, v, f, colors=mesh.get("colors") if color else None,
              labels=mesh.get("labels") if label else None)
    if label and "label_colors" in mesh:
        write_ply(os.path.join(out_dir, f"mesh_{idx}_semantic.ply"), v, f,
                  colors=mesh["label_colors"] / 255.0, labels=mesh.get("labels"))
    if element:
        labs = mesh.get("labels")
        for c in np.unique(labs):
            sel = labs[f].max(1) == c
            if sel.sum():
                write_ply(os.path.join(out_dir, f"mesh_{idx}_part_{c}.ply"), v, f[sel],
                          colors=mesh.get("colors"))
    print(f"mesh_{idx}.ply saved ({v.shape[0]} verts)")
    return path
