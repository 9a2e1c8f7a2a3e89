"""3D reconstruction metrics: accuracy / completion / completion ratio, and
depth L1 from random virtual views.

The port's own copy of dnsjax/eval/mesh_metrics.py, equal to it (the port
imports nothing of dnsjax; tests/test_torch_shared.py holds the two
together): 200k area-weighted surface samples on each mesh, nearest-neighbour
distances both ways through scipy's KD-tree; the virtual views trace both
meshes with the native raycaster (``dnsjax_torch.mesh.raycast``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial import cKDTree


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int, seed: int = 0):
    """Uniform area-weighted surface samples."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = (verts[faces[:, k]].astype(np.float64) for k in range(3))
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    p = area / max(area.sum(), 1e-12)
    tri = rng.choice(len(faces), size=n, p=p)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return v0[tri] + u * (v1[tri] - v0[tri]) + v * (v2[tri] - v0[tri])


def mesh_metrics(
    rec_verts: np.ndarray,
    rec_faces: np.ndarray,
    gt_verts: np.ndarray,
    gt_faces: np.ndarray,
    n_samples: int = 200_000,
    thresh: float = 0.05,
) -> Dict[str, float]:
    """accuracy/completion in cm, completion ratio (% within ``thresh`` m)."""
    rec_pts = sample_surface(rec_verts, rec_faces, n_samples, seed=0)
    gt_pts = sample_surface(gt_verts, gt_faces, n_samples, seed=1)

    d_rec_to_gt = cKDTree(gt_pts).query(rec_pts, k=1)[0]  # accuracy
    d_gt_to_rec = cKDTree(rec_pts).query(gt_pts, k=1)[0]  # completion

    return {
        "accuracy_cm": float(d_rec_to_gt.mean() * 100),
        "completion_cm": float(d_gt_to_rec.mean() * 100),
        "completion_ratio_pct": float((d_gt_to_rec < thresh).mean() * 100),
    }


def depth_l1_virtual_views(
    rec_verts: np.ndarray,
    rec_faces: np.ndarray,
    gt_verts: np.ndarray,
    gt_faces: np.ndarray,
    n_views: int = 100,
    H: int = 240,
    W: int = 320,
    seed: int = 0,
) -> dict:
    """Depth-L1 (cm) between both meshes rendered from random virtual views.

    Views: random positions inside the GT bounding box, looking at a random
    unit-sphere direction, 90-degree hfov pinhole; pixels where either mesh
    misses are excluded. Raises RuntimeError if the native raycaster cannot
    be built.
    """
    from dnsjax_torch.mesh.raycast import MeshRaycaster

    rng = np.random.default_rng(seed)
    rc_rec = MeshRaycaster(rec_verts, rec_faces)
    rc_gt = MeshRaycaster(gt_verts, gt_faces)

    lo, hi = gt_verts.min(0), gt_verts.max(0)
    fx = W / 2.0
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    j, i = np.meshgrid(np.arange(H, dtype=np.float64),
                       np.arange(W, dtype=np.float64), indexing="ij")
    dirs_cam = np.stack([(i - cx) / fx, -(j - cy) / fx, -np.ones_like(i)], -1)
    dirs_cam = dirs_cam.reshape(-1, 3)

    errs = []
    for _ in range(n_views):
        pos = lo + rng.random(3) * (hi - lo)
        # random look direction -> rotation with -z toward it
        z = rng.normal(size=3)
        z /= np.linalg.norm(z)
        up = np.array([0.0, 1.0, 0.0])
        if abs(z @ up) > 0.95:
            up = np.array([1.0, 0.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, -z], -1)  # camera -z looks along +z dir chosen
        d = dirs_cam @ R.T
        o = np.broadcast_to(pos, d.shape)
        t_rec = rc_rec.trace(o, d)
        t_gt = rc_gt.trace(o, d)
        ok = (t_rec > 0) & (t_gt > 0)
        if ok.sum() > 100:
            errs.append(np.abs(t_rec[ok] - t_gt[ok]).mean())
    return {
        "depth_l1_cm": float(np.mean(errs) * 100) if errs else float("nan"),
        "n_valid_views": len(errs),
    }
