"""The visualizer's 3D view, drawn with OpenCV: what dnsjax's
``cli/visualizer.py:_draw`` draws with matplotlib's 3D axes (not present
where the port runs on the card).

A fixed view (matplotlib's default: elevation 30 degrees, azimuth -60, z up)
with an orthographic projection of an equal-aspect box around the mesh (or,
without one, the trajectories), fitted to the image. The mesh's flat-shaded
faces are filled far to near (painter's order) or its points are dotted;
then the GT trajectory in black and the estimate in red up to frame ``idx``,
faint estimated camera glyphs every ``every`` frames before it, and the
current estimated (red, bold) and GT (black) glyphs. Positions-only
trajectories (N, 3) get a marker at the current estimate instead of glyphs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_BLACK = (0, 0, 0)
_RED = (40, 39, 214)  # BGR of matplotlib's tab:red


def view_matrix(elev: float = 30.0, azim: float = -60.0) -> np.ndarray:
    """(3, 3) rows: screen right, screen up, towards the viewer, of a camera
    at elevation ``elev`` and azimuth ``azim`` (degrees) looking at the
    origin with z up."""
    e, a = np.radians(elev), np.radians(azim)
    toward = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    return np.stack([right, np.cross(toward, right), toward])


def draw_scene(est, gt, mesh: Optional[dict], idx: int, title: Optional[str] = None,
               every: int = 5, cam_scale: float = 0.1, width: int = 700,
               height: int = 600) -> np.ndarray:
    """The view as a (height, width, 3) uint8 BGR image. ``est`` / ``gt``:
    (N, 3|4, 4) poses or (N, 3) positions; ``mesh``: ``_load_mesh``'s dict
    (``tris`` + ``fc``, or ``pts`` + ``c``) or None."""
    import cv2

    from dnsjax_torch.cli.visualizer import _camera_segments

    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    has_rot = est.ndim == 3
    est_p = est[:, :3, 3] if has_rot else est
    gt_p = gt[:, :3, 3] if has_rot else gt
    segs = []  # (segments (n, 2, 3), BGR, thickness, alpha)
    if has_rot:
        past = [_camera_segments(est[k], cam_scale) for k in range(0, idx, max(1, every))]
        if past:
            segs.append((np.concatenate(past), _RED, 1, 0.3))
        segs.append((_camera_segments(est[idx], cam_scale), _RED, 2, 1.0))
        segs.append((_camera_segments(gt[idx], cam_scale), _BLACK, 1, 1.0))

    # the box: the mesh's extent if there is one (as dnsjax scales to it),
    # else the trajectories' and glyphs'
    if mesh is not None:
        cloud = mesh["tris"].reshape(-1, 3) if "tris" in mesh else mesh["pts"]
    else:
        cloud = np.concatenate([gt_p[: idx + 1], est_p[: idx + 1]]
                               + [s[0].reshape(-1, 3) for s in segs])
    lo, hi = cloud.min(0), cloud.max(0)
    center, half = (lo + hi) / 2, max(float((hi - lo).max()) / 2, 1e-6)
    V = view_matrix()
    margin = 40
    scale = (min(width, height) / 2 - margin) / (half * np.sqrt(3))

    def project(p):
        q = (np.asarray(p, np.float64).reshape(-1, 3) - center) @ V.T
        uv = np.stack([width / 2 + q[:, 0] * scale, height / 2 - q[:, 1] * scale], -1)
        return uv, q[:, 2]

    img = np.full((height, width, 3), 255, np.uint8)
    if mesh is not None and "tris" in mesh:
        uv, depth = project(mesh["tris"])
        uv = uv.reshape(-1, 3, 2)
        order = np.argsort(depth.reshape(-1, 3).mean(1), kind="stable")  # far first
        colors = np.round(mesh["fc"][:, 2::-1] * 255).astype(np.int64)
        tri = np.round(uv * 16).astype(np.int32)  # 4 fractional bits
        for f in order:
            cv2.fillConvexPoly(img, tri[f], tuple(int(c) for c in colors[f]), cv2.LINE_AA, 4)
    elif mesh is not None:
        uv, _ = project(mesh["pts"])
        c = mesh.get("c")
        overlay = img.copy()
        for k, (u, v) in enumerate(np.round(uv).astype(np.int32)):
            col = _BLACK if c is None else tuple(int(x) for x in np.round(c[k][2::-1] * 255))
            cv2.circle(overlay, (int(u), int(v)), 1, col, -1)
        img = cv2.addWeighted(overlay, 0.35, img, 0.65, 0)

    def polyline(p, color, thickness=2):
        if len(p) > 1:
            pts = np.round(project(p)[0]).astype(np.int32).reshape(-1, 1, 2)
            cv2.polylines(img, [pts], False, color, thickness, cv2.LINE_AA)

    polyline(gt_p[: idx + 1], _BLACK)
    polyline(est_p[: idx + 1], _RED)
    for seg, color, thick, alpha in segs:
        layer = img.copy()
        for a, b in np.round(project(seg)[0]).astype(np.int32).reshape(-1, 2, 2):
            cv2.line(layer, tuple(int(x) for x in a), tuple(int(x) for x in b), color, thick,
                     cv2.LINE_AA)
        img = layer if alpha >= 1.0 else cv2.addWeighted(layer, alpha, img, 1 - alpha, 0)
    if not has_rot:
        u, v = np.round(project(est_p[idx])[0][0]).astype(np.int32)
        tri = np.array([[u, v - 8], [u - 7, v + 5], [u + 7, v + 5]], np.int32)
        cv2.fillConvexPoly(img, tri, _RED, cv2.LINE_AA)

    font = cv2.FONT_HERSHEY_SIMPLEX
    text = title or f"frame {idx}"
    (tw, _), _ = cv2.getTextSize(text, font, 0.7, 2)
    cv2.putText(img, text, ((width - tw) // 2, 28), font, 0.7, _BLACK, 2, cv2.LINE_AA)
    for k, (name, color) in enumerate((("gt", _BLACK), ("est", _RED))):
        y = 22 + 22 * k
        cv2.line(img, (12, y - 5), (40, y - 5), color, 2, cv2.LINE_AA)
        cv2.putText(img, name, (46, y), font, 0.5, _BLACK, 1, cv2.LINE_AA)
    return img
