"""Absolute trajectory error with Horn closed-form alignment.

Counterpart of the reference eval_ate.py (align at eval_ate.py:45-79,
evaluate_ate at 114-224): associate est/gt trajectories, solve the
similarity-free rigid alignment via SVD (Horn's method), report RMSE and
distribution stats of the residual translations. NaN/inf GT poses (ScanNet)
are masked out, as the reference does (eval_ate.py:240-257).

The port's own copy of dnsjax/eval/ate.py, equal to it (the port imports nothing of
dnsjax; tests/test_torch_shared.py holds the two together).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def align_horn(model: np.ndarray, data: np.ndarray):
    """Rigid alignment model -> data, both (3, N). Returns (R, t, trans_error).

    Solves argmin_{R,t} || (R @ model + t) - data ||^2 via SVD.
    """
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    mc = model - model_mean
    dc = data - data_mean
    W = mc @ dc.T
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    t = data_mean - R @ model_mean
    aligned = R @ model + t
    err = np.linalg.norm(aligned - data, axis=0)
    return R, t, err


def evaluate_ate(
    est_c2w: np.ndarray, gt_c2w: np.ndarray, plot_path: Optional[str] = None
) -> Dict[str, float]:
    """est/gt (N, 4, 4) -> ATE stats dict (m). Masks invalid GT poses."""
    gt_t = gt_c2w[:, :3, 3]
    est_t = est_c2w[:, :3, 3]
    ok = np.isfinite(gt_t).all(-1) & np.isfinite(est_t).all(-1)
    est_m = est_t[ok].T
    gt_m = gt_t[ok].T
    _, _, err = align_horn(est_m, gt_m)

    stats = {
        "compared_pose_pairs": int(ok.sum()),
        "absolute_translational_error.rmse": float(np.sqrt((err**2).mean())),
        "absolute_translational_error.mean": float(err.mean()),
        "absolute_translational_error.median": float(np.median(err)),
        "absolute_translational_error.std": float(err.std()),
        "absolute_translational_error.min": float(err.min()),
        "absolute_translational_error.max": float(err.max()),
    }

    if plot_path is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 6))
        ax.plot(gt_m[0], gt_m[1], "-", color="black", label="ground truth")
        R, t, _ = align_horn(est_m, gt_m)
        al = R @ est_m + t
        ax.plot(al[0], al[1], "-", color="blue", label="estimated")
        ax.legend()
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_title(f"ATE RMSE {stats['absolute_translational_error.rmse']:.4f} m")
        fig.savefig(plot_path, dpi=120, bbox_inches="tight")
        plt.close(fig)

    return stats
