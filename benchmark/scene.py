"""The procedural "rich" room that every sequence of the benchmark shows.

A frozen copy of the port's textured synthetic scene
(``dnsjax_torch/data/synthetic.py``, ``texture: rich``), rewritten in plain
torch so that it renders on the card: a box room of half-extent 2 m, six
shaded spheres, a multi-octave wave texture on the walls drawn from the
seed, 24 wall-panel classes and one class a sphere (30 in all), and a
closed orbit of 200 frames (about 1.3 cm and 1.1 degrees a frame).
The arithmetic is the original's, in float64.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

ROOM_HALF = 2.0
ORBIT_FRAMES = 200
N_WALL_CLASS = 24
SPHERES = (
    ((0.8, -0.4, -1.0), 0.5, (0.9, 0.2, 0.2)),
    ((-0.9, 0.2, 0.6), 0.4, (0.2, 0.4, 0.9)),
    ((0.1, 0.9, 0.2), 0.35, (0.2, 0.8, 0.3)),
    ((-0.5, -0.8, -0.6), 0.3, (0.85, 0.7, 0.2)),
    ((1.1, 0.6, 0.9), 0.35, (0.6, 0.25, 0.8)),
    ((-1.2, -0.2, 1.1), 0.25, (0.2, 0.75, 0.75)),
)
N_CLASS = N_WALL_CLASS + len(SPHERES)


def orbit_pose(i: int) -> np.ndarray:
    """Camera-to-world (4, 4) float32 of frame ``i``, -z forward (OpenGL):
    a yaw sweep of +-0.6 rad on a 0.4 m circle, one lap in 200 frames."""
    t = i / float(ORBIT_FRAMES)
    ang = 0.6 * math.sin(2 * math.pi * t)
    pos = np.array([0.4 * math.sin(2 * math.pi * t), 0.15 * math.sin(4 * math.pi * t),
                    0.4 * math.cos(2 * math.pi * t)])
    c, s = math.cos(ang), math.sin(ang)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)
    c2w[:3, 3] = pos.astype(np.float32)
    return c2w


class RichScene:
    """Renders frames of the room for one camera; the wall texture is drawn
    from ``seed`` as the original draws it (numpy, ``seed + 17``)."""

    def __init__(self, seed: int, H: int, W: int, fx: float, fy: float, cx: float, cy: float,
                 device="cpu"):
        self.H, self.W, self.device = H, W, torch.device(device)
        r = np.random.default_rng(int(seed) + 17)
        n_waves = 10
        dirs = r.normal(size=(n_waves, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        freqs = np.exp(r.uniform(np.log(2.0), np.log(24.0), n_waves))
        amps = 0.5 / np.sqrt(np.arange(1, n_waves + 1))
        f64 = dict(dtype=torch.float64, device=self.device)
        self.kvecs = torch.as_tensor(dirs * freqs[:, None], **f64)
        self.phases = torch.as_tensor(r.uniform(0, 2 * np.pi, n_waves), **f64)
        self.amps = torch.as_tensor(amps / amps.sum(), **f64)
        j, i = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64), indexing="ij")
        self.dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], -1)

    def render(self, c2w: np.ndarray) -> Dict[str, torch.Tensor]:
        """color (H, W, 3) in [0.02, 0.98], depth (H, W) in metres (view
        space, which for this camera is the ray parameter), label (H, W)
        int64 class ids, all float64/int64 on the scene's device."""
        m = torch.as_tensor(np.asarray(c2w, np.float64), device=self.device)
        rd = (self.dirs @ m[:3, :3].T).reshape(-1, 3)
        ro = m[:3, 3].expand_as(rd)
        h = ROOM_HALF
        t_planes = (torch.tensor([-h, h], dtype=torch.float64, device=self.device)
                    - ro[..., None]) / rd[..., None]
        t_hit = t_planes.amax(-1).amin(-1)
        hit = ro + rd * t_hit[:, None]
        axis = torch.argmax((hit / h).abs(), -1)
        base = torch.stack([0.45 + 0.12 * (axis == k) for k in range(3)], -1)
        checker = torch.remainder(torch.floor(hit * 2).sum(-1), 2) * 0.18
        waves = torch.sin(hit @ self.kvecs.T * (2 * math.pi / h) + self.phases)
        tex = waves @ self.amps
        color = torch.clamp(base * (0.75 + 0.35 * tex[:, None]) + checker[:, None] * 0.5,
                            0.02, 0.98)
        side = (torch.gather(hit, 1, axis[:, None])[:, 0] > 0).to(torch.int64)
        uv = torch.gather(hit, 1, torch.stack([(axis + 1) % 3, (axis + 2) % 3], -1))
        label = (axis * 2 + side) * 4 + (uv[:, 0] > 0).to(torch.int64) * 2 \
            + (uv[:, 1] > 0).to(torch.int64)
        for k, (cen, rad, col) in enumerate(SPHERES):
            cen = torch.tensor(cen, dtype=torch.float64, device=self.device)
            col = torch.tensor(col, dtype=torch.float64, device=self.device)
            oc = ro - cen
            b = (oc * rd).sum(-1)
            a = (rd * rd).sum(-1)
            disc = b * b - a * ((oc * oc).sum(-1) - rad * rad)
            t_s = torch.where(disc > 0, (-b - torch.sqrt(torch.clamp(disc, min=0))) / a,
                              torch.full_like(b, math.inf))
            closer = (t_s > 1e-3) & (t_s < t_hit)
            t_hit = torch.where(closer, t_s, t_hit)
            nrm = (ro + rd * t_s[:, None] - cen) / rad
            shade = 0.6 + 0.4 * torch.clamp(nrm[:, 1] * 0.5 + nrm[:, 2] * 0.5, -1, 1)
            color = torch.where(closer[:, None], col * shade[:, None], color)
            label = torch.where(closer, torch.full_like(label, N_WALL_CLASS + k), label)
        H, W = self.H, self.W
        return {"color": color.reshape(H, W, 3), "depth": t_hit.reshape(H, W),
                "label": label.reshape(H, W)}
