"""The ATE trajectory plot, drawn with OpenCV: what dnsjax's
``eval/ate.py:evaluate_ate(plot_path=...)`` draws with matplotlib (not present
where the port runs on the card). The port's ``eval/ate.py`` stays equal to
dnsjax's and plots nothing, so ``cli/eval_ate.py`` calls this instead.

The x-y positions of the poses that are finite in both trajectories: the
ground truth in black and the Horn-aligned estimate in blue, the ATE RMSE as
the title, axes in metres scaled to the data (each axis on its own, as
matplotlib scales them), with a legend.
"""

from __future__ import annotations

import numpy as np

from dnsjax_torch.eval.ate import align_horn

_BLACK = (0, 0, 0)
_BLUE = (255, 0, 0)  # BGR
_GREY = (128, 128, 128)


def aligned_trajectory(est_c2w: np.ndarray, gt_c2w: np.ndarray):
    """(gt (3, M), Horn-aligned estimate (3, M)): the positions that
    ``evaluate_ate`` aligns, over the poses finite in both."""
    gt_t = gt_c2w[:, :3, 3]
    est_t = est_c2w[:, :3, 3]
    ok = np.isfinite(gt_t).all(-1) & np.isfinite(est_t).all(-1)
    est_m = est_t[ok].T
    gt_m = gt_t[ok].T
    R, t, _ = align_horn(est_m, gt_m)
    return gt_m, R @ est_m + t


def write_ate_plot(path: str, est_c2w: np.ndarray, gt_c2w: np.ndarray, rmse: float,
                   size: int = 720) -> np.ndarray:
    """Draw the plot into ``path`` (a ``size`` x ``size`` image); returns the
    aligned estimate (3, M) it drew."""
    import cv2

    gt_m, al = aligned_trajectory(est_c2w, gt_c2w)
    left, right, top, bottom = 100, 30, 60, 70
    pw, ph = size - left - right, size - top - bottom
    img = np.full((size, size, 3), 255, np.uint8)

    def limits(v):
        lo, hi = float(v.min()), float(v.max())
        pad = max(hi - lo, 1e-6) * 0.05
        return lo - pad, hi + pad

    (x0, x1), (y0, y1) = limits(np.concatenate([gt_m[0], al[0]])), \
        limits(np.concatenate([gt_m[1], al[1]]))

    def px(x, y):
        u = left + (np.asarray(x) - x0) / (x1 - x0) * pw
        v = top + (y1 - np.asarray(y)) / (y1 - y0) * ph
        return np.stack([u, v], -1).round().astype(np.int32).reshape(-1, 1, 2)

    font = cv2.FONT_HERSHEY_SIMPLEX
    cv2.rectangle(img, (left, top), (left + pw, top + ph), _BLACK, 1)
    for k in range(5):
        xv, yv = x0 + (x1 - x0) * k / 4, y0 + (y1 - y0) * k / 4
        (u, _), (_, v) = px(xv, y0)[0, 0], px(x0, yv)[0, 0]
        cv2.line(img, (int(u), top + ph), (int(u), top + ph + 6), _BLACK, 1)
        cv2.putText(img, f"{xv:.2f}", (int(u) - 22, top + ph + 24), font, 0.45, _BLACK, 1,
                    cv2.LINE_AA)
        cv2.line(img, (left - 6, int(v)), (left, int(v)), _BLACK, 1)
        cv2.putText(img, f"{yv:.2f}", (left - 60, int(v) + 5), font, 0.45, _BLACK, 1,
                    cv2.LINE_AA)
    cv2.putText(img, "x [m]", (left + pw // 2 - 20, size - 18), font, 0.55, _BLACK, 1,
                cv2.LINE_AA)
    cv2.putText(img, "y [m]", (8, top - 12), font, 0.55, _BLACK, 1, cv2.LINE_AA)
    cv2.putText(img, f"ATE RMSE {rmse:.4f} m", (left + pw // 2 - 110, 36), font, 0.8,
                _BLACK, 2, cv2.LINE_AA)
    cv2.polylines(img, [px(gt_m[0], gt_m[1])], False, _BLACK, 2, cv2.LINE_AA)
    cv2.polylines(img, [px(al[0], al[1])], False, _BLUE, 2, cv2.LINE_AA)
    lx, ly = left + pw - 190, top + 12
    cv2.rectangle(img, (lx, ly), (lx + 180, ly + 52), _GREY, 1)
    for k, (name, color) in enumerate((("ground truth", _BLACK), ("estimated", _BLUE))):
        y = ly + 18 + 22 * k
        cv2.line(img, (lx + 8, y - 4), (lx + 40, y - 4), color, 2, cv2.LINE_AA)
        cv2.putText(img, name, (lx + 48, y), font, 0.5, _BLACK, 1, cv2.LINE_AA)
    if not cv2.imwrite(path, img):
        raise OSError(f"could not write {path}")
    return al
