"""Procedural synthetic RGB-D semantic dataset.

A self-contained test scene so tests and the SLAM loop need no Replica
download (the reference has no such fixture — SURVEY.md §4 calls for one). The scene
is a box room containing a few spheres; color, depth, and per-pixel class
labels are ray-traced analytically in numpy, and the camera follows a smooth
orbit. Frames are deterministic functions of (seed, index).

Classes: 0 = walls/floor/ceiling, 1.. = one per object.

The port's own copy of dnsjax/data/synthetic.py, equal to it (the port imports nothing of
dnsjax; tests/test_torch_shared.py holds the two together).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np


class SyntheticDataset:
    name = "synthetic"
    semantic = True

    def __init__(self, cfg: Dict[str, Any], input_folder: str = "", scale: float = 1.0):
        cam = cfg["cam"]
        self.H, self.W = int(cam["H"]), int(cam["W"])
        self.fx, self.fy = float(cam["fx"]), float(cam["fy"])
        self.cx, self.cy = float(cam["cx"]), float(cam["cy"])
        self.crop_edge = 0
        syn = cfg.get("synthetic", {})
        self.n_img = int(syn.get("n_frames", 60))
        self.seed = int(syn.get("seed", 0))
        self.scale = scale

        # room [-2,2]^2 x [-2,2], objects: spheres (center, radius, color)
        self.room_half = 2.0
        self.spheres = [
            (np.array([0.8, -0.4, -1.0]), 0.5, np.array([0.9, 0.2, 0.2])),
            (np.array([-0.9, 0.2, 0.6]), 0.4, np.array([0.2, 0.4, 0.9])),
            (np.array([0.1, 0.9, 0.2]), 0.35, np.array([0.2, 0.8, 0.3])),
        ]

        # texture="rich": the TPU-profile quality gate scene — procedural
        # multi-octave wall texture, 24 per-panel wall classes (+1 per
        # object), extra spheres; used by scripts/ab_quality.py to validate
        # encoding/precision deviations at realistic texture frequency.
        self.texture = str(syn.get("texture", "flat"))
        if self.texture == "rich":
            self.spheres = self.spheres + [
                (np.array([-0.5, -0.8, -0.6]), 0.3, np.array([0.85, 0.7, 0.2])),
                (np.array([1.1, 0.6, 0.9]), 0.35, np.array([0.6, 0.25, 0.8])),
                (np.array([-1.2, -0.2, 1.1]), 0.25, np.array([0.2, 0.75, 0.75])),
            ]
            r = np.random.default_rng(self.seed + 17)
            n_waves = 10
            dirs = r.normal(size=(n_waves, 3))
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
            freqs = np.exp(r.uniform(np.log(2.0), np.log(24.0), n_waves))
            self._tex_waves = (
                dirs * freqs[:, None],
                r.uniform(0, 2 * np.pi, n_waves),
                0.5 / np.sqrt(np.arange(1, n_waves + 1)),
            )
            self.n_wall_class = 24  # 6 walls x 2x2 panels
        else:
            self.n_wall_class = 1

        self.n_class = self.n_wall_class + len(self.spheres)
        self.label2class_dict = {i: i for i in range(self.n_class)}
        self.class2label_dict = {i: i for i in range(self.n_class)}

        self.poses = [self._pose(i) for i in range(self.n_img)]

    def update_cam_for_crop(self):
        pass

    def _pose(self, i: int) -> np.ndarray:
        """Smooth orbit around the origin, looking outward to the walls,
        -z-forward convention. Per-frame motion is fixed (~1.3 cm, ~1.1 deg)
        regardless of sequence length — realistic SLAM frame-to-frame speed."""
        t = i / 200.0
        ang = 0.6 * math.sin(2 * math.pi * t)  # yaw sweep, +-0.6 rad
        pos = np.array(
            [0.4 * math.sin(2 * math.pi * t), 0.15 * math.sin(4 * math.pi * t), 0.4 * math.cos(2 * math.pi * t)]
        )
        c, s = math.cos(ang), math.sin(ang)
        # yaw about +y; camera looks along -z of its own frame
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R.astype(np.float32)
        c2w[:3, 3] = pos.astype(np.float32)
        return c2w

    def __len__(self):
        return self.n_img

    def _rays(self, c2w: np.ndarray):
        j, i = np.meshgrid(
            np.arange(self.H, dtype=np.float64),
            np.arange(self.W, dtype=np.float64),
            indexing="ij",
        )
        dirs = np.stack(
            [(i - self.cx) / self.fx, -(j - self.cy) / self.fy, -np.ones_like(i)], -1
        )
        rd = dirs @ c2w[:3, :3].T
        ro = np.broadcast_to(c2w[:3, 3], rd.shape)
        return ro.reshape(-1, 3), rd.reshape(-1, 3)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        c2w = self.poses[index]
        ro, rd = self._rays(c2w.astype(np.float64))
        n = ro.shape[0]
        t_hit = np.full(n, np.inf)
        color = np.zeros((n, 3))
        label = np.zeros(n, np.int32)

        # room walls: exit of the axis-aligned box along each ray
        h = self.room_half
        with np.errstate(divide="ignore", invalid="ignore"):
            t_planes = (np.array([[-h, h]]) - ro[..., None]) / rd[..., None]
        t_exit = np.min(np.max(t_planes, axis=-1), axis=-1)
        # wall shading: checkerboard by hit position, hue by dominant axis
        hit = ro + rd * t_exit[:, None]
        axis = np.argmax(np.abs(hit / h), axis=-1)
        base = np.stack(
            [0.45 + 0.12 * (axis == 0), 0.45 + 0.12 * (axis == 1), 0.45 + 0.12 * (axis == 2)],
            -1,
        )
        checker = ((np.floor(hit[:, 0] * 2) + np.floor(hit[:, 1] * 2) + np.floor(hit[:, 2] * 2)) % 2) * 0.18
        t_hit = t_exit
        color = base + checker[:, None]

        if self.texture == "rich":
            # multi-octave directional waves -> high-frequency wallpaper
            kvecs, phases, amps = self._tex_waves
            waves = np.sin(hit @ kvecs.T * (2 * np.pi / h) + phases)  # (n, W)
            tex = waves @ amps / amps.sum()  # in ~[-1, 1]
            color = np.clip(
                base * (0.75 + 0.35 * tex[:, None]) + checker[:, None] * 0.5,
                0.02, 0.98,
            )
            # wall label: axis (3) x side (2) x 2x2 panel of the wall plane
            side = (np.take_along_axis(hit, axis[:, None], 1)[:, 0] > 0).astype(np.int64)
            uv_ax = np.stack([(axis + 1) % 3, (axis + 2) % 3], -1)
            uv = np.take_along_axis(hit, uv_ax, 1)
            pu = (uv[:, 0] > 0).astype(np.int64)
            pv = (uv[:, 1] > 0).astype(np.int64)
            label = ((axis * 2 + side) * 4 + pu * 2 + pv).astype(np.int32)

        # spheres (inf t for misses flows through shading harmlessly)
        err = np.errstate(invalid="ignore", over="ignore")
        err.__enter__()
        for k, (cen, rad, col) in enumerate(self.spheres):
            oc = ro - cen
            b = np.sum(oc * rd, -1)
            a = np.sum(rd * rd, -1)
            disc = b * b - a * (np.sum(oc * oc, -1) - rad * rad)
            ok = disc > 0
            t_s = np.where(ok, (-b - np.sqrt(np.maximum(disc, 0))) / a, np.inf)
            closer = (t_s > 1e-3) & (t_s < t_hit)
            t_hit = np.where(closer, t_s, t_hit)
            # simple lambertian-ish shading by normal
            p = ro + rd * t_s[:, None]
            nrm = (p - cen) / rad
            shade = 0.6 + 0.4 * np.clip(nrm[:, 1] * 0.5 + nrm[:, 2] * 0.5, -1, 1)
            color = np.where(closer[:, None], col * shade[:, None], color)
            label = np.where(closer, self.n_wall_class + k, label)
        err.__exit__(None, None, None)

        # depth is the ray-parameter (z_vals convention: t along unnormalized
        # dir); the reference datasets store sensor (view-space) depth, which
        # for this camera model equals t (dir z-component is -1): d = t * 1
        depth = t_hit.copy()

        return {
            "index": index,
            "color": color.reshape(self.H, self.W, 3).astype(np.float32),
            "depth": depth.reshape(self.H, self.W).astype(np.float32) * self.scale,
            "label": label.reshape(self.H, self.W).astype(np.int32),
            "c2w": c2w.astype(np.float32),
        }


def synthetic_slam_config(
    H=60, W=80, n_frames=12, n_iters_track=10, n_iters_map=20, n_pixels_map=400,
) -> Dict[str, Any]:
    """Full SLAM config over the synthetic scene, scaled for fast CI runs."""
    cfg = synthetic_config(H=H, W=W, n_frames=n_frames)
    cfg.update(
        {
            "out_dir": "output",
            "verbose": False,
            "sync_method": "strict",
            "use_gt_camera": False,
            "const_speed_assumption": True,
            "seperate_LR": False,
            "scale": 1,
            "bound_divisible": 0.32,
            "seed": 0,
            "model": {
                "pts_dim": 3,
                "pixel_dim": 64,
                "hidden_dim": 32,
                "pos": {"method": "OneBlob", "n_bins": 16},
                "grid": {
                    "method": "HashGrid",
                    "hash_size": 13,
                    "voxel_size": 0.04,
                    "n_levels": 8,
                    "level_dim": 2,
                    "base_resolution": 8,
                },
            },
            "training": {
                "lr": 0.005,
                "lambda_color": 5.0,
                "lambda_depth": 5.0,
                "lambda_label": 0.1,
                "lambda_smooth": 0.00001,
                "lambda_fs": 10,
                "lambda_opacity": 10,
                "n_samples_ray": 24,
                "n_surface_ray": 8,
                "smooth_pts": 16,
                "opacity_sigma": 0.05,
            },
            "tracking": {
                "cam_lr": 0.002,
                "n_iters": n_iters_track,
                "n_pixels": 200,
                "ignore_edge": 5,
            },
            "mapping": {
                "BA_cam_lr": 0.0005,
                "start_optimize_idx": 10,
                "n_joint_optimize_frames": 3,
                "n_refer_frames": 2,
                "n_pixels": n_pixels_map,
                "n_iters": n_iters_map,
                "n_iters_first": n_iters_map * 3,
                "n_pts_batch": 1000,
                "optimize_every_n_frames": 3,
                "choose_keyframe_every": 6,
                "vis_every": 0,
                "mesh_every": 0,
                "checkpoint_every": 0,
                "max_keyframes": 16,
            },
            "meshing": {
                "resolution": 64,
                "points_batch_size": 65536,
                "level_set": 0.0,
                "color": True,
                "label": True,
                "clean_mesh": False,
            },
            "tpu": {"compute_dtype": "bfloat16", "fix_refer_frame_bug": True},
        }
    )
    return cfg


def synthetic_config(H=120, W=160, n_frames=30) -> Dict[str, Any]:
    """A ready-to-use config dict for tests/driver smoke runs."""
    fx = W / 2.0  # 90-degree hfov like Replica
    return {
        "dataset": "synthetic",
        "scene": "synthetic",
        "cam": {
            "H": H,
            "W": W,
            "fx": fx,
            "fy": fx,
            "cx": (W - 1) / 2.0,
            "cy": (H - 1) / 2.0,
            "png_depth_scale": 1000.0,
            "crop_edge": 0,
        },
        "synthetic": {"n_frames": n_frames, "seed": 0},
        "back_end": {
            "bound": [[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]],
            "marching_cubes_bound": [[-2.1, 2.1], [-2.1, 2.1], [-2.1, 2.1]],
        },
    }
