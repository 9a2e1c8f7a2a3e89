"""The 3x3 residual panel, written with OpenCV: port of dnsjax/viz/panels.py,
which draws with matplotlib (not present where the port runs on the card).

Rows are depth / RGB / semantic label, columns input / generated / residual,
saved as ``{out_dir}/{idx:05d}.jpg``. Depth and labels are colored with the
plasma map (depth over [0, max input depth], labels over [0, max_label]),
as dnsjax's panel colors them; each tile carries its title.
"""

from __future__ import annotations

import os

import numpy as np

_TITLES = (("Input Depth", "Generated Depth", "Depth Residual"),
           ("Input RGB", "Generated RGB", "RGB Residual"),
           ("Input Label", "Generated Label", "Label Residual"))


def _plasma(x: np.ndarray, vmax: float) -> np.ndarray:
    import cv2

    scaled = np.clip(np.asarray(x, np.float64) / max(vmax, 1e-12), 0.0, 1.0)
    bgr = cv2.applyColorMap((scaled * 255).astype(np.uint8), cv2.COLORMAP_PLASMA)
    return bgr


def _rgb(x: np.ndarray) -> np.ndarray:
    import cv2

    img = (np.clip(np.asarray(x, np.float64), 0.0, 1.0) * 255).astype(np.uint8)
    return cv2.cvtColor(img, cv2.COLOR_RGB2BGR)


def residual_panel(idx: int, out_dir: str, gt_color: np.ndarray, est_color: np.ndarray,
                   gt_depth: np.ndarray, est_depth: np.ndarray, gt_label: np.ndarray,
                   est_label: np.ndarray, max_label: int = 101) -> str:
    """Write the panel; returns its path."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    vmax = float(np.max(gt_depth))
    label_res = np.abs(gt_label.astype(np.float64) - est_label.astype(np.float64))
    rows = [
        [_plasma(gt_depth, vmax), _plasma(est_depth, vmax),
         _plasma(np.abs(gt_depth - est_depth), vmax)],
        [_rgb(gt_color), _rgb(est_color), _rgb(np.abs(gt_color - est_color))],
        [_plasma(gt_label, max_label), _plasma(est_label, max_label),
         _plasma(label_res, max_label)],
    ]
    H, W = rows[0][0].shape[:2]
    bar = max(16, H // 12)
    tiles = []
    for r, row in enumerate(rows):
        out = []
        for c, img in enumerate(row):
            tile = np.full((H + bar, W, 3), 255, np.uint8)
            tile[bar:] = img
            cv2.putText(tile, _TITLES[r][c], (4, bar - 4), cv2.FONT_HERSHEY_SIMPLEX,
                        bar / 30.0, (0, 0, 0), 1, cv2.LINE_AA)
            out.append(tile)
        tiles.append(np.concatenate(out, 1))
    path = os.path.join(out_dir, f"{idx:05d}.jpg")
    if not cv2.imwrite(path, np.concatenate(tiles, 0)):
        raise OSError(f"could not write {path}")
    return path
