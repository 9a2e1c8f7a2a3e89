"""Semantic mIoU over saved rendered label images against the dataset's GT:
``python -m dnsjax_torch.cli.eval_semantic <config> [--renders DIR]``.

As dnsjax.cli.eval_semantic: one confusion matrix over every
``semantic_*.png`` in ``--renders`` (default ``<out>/renders``, where
``eval_2d`` writes raw class ids), then mIoU over the classes with more than
``--min-support`` GT pixels, total accuracy, and the counts. Host only.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str)
    parser.add_argument("--input", type=str, default=None)
    parser.add_argument("--renders", type=str, default=None,
                        help="dir with semantic_*.png (default <out>/renders)")
    parser.add_argument("--min-support", type=int, default=100)
    args = parser.parse_args(argv)

    import cv2

    from dnsjax_torch.config import load_config
    from dnsjax_torch.data import get_dataset
    from dnsjax_torch.eval.semantic import confusion_matrix

    cfg = load_config(
        args.config,
        "configs/slam.yaml" if os.path.exists("configs/slam.yaml") else None,
    )
    if args.input:
        cfg["input_folder"] = args.input
    out = os.path.join(cfg.get("out_dir", "output"), cfg.get("scene", "scene"))
    rdir = args.renders or os.path.join(out, "renders")

    input_folder = cfg.get("input_folder") or os.path.join(
        cfg.get("dataset_dir", ""), cfg.get("scene", "")
    )
    ds = get_dataset(cfg, input_folder, float(cfg.get("scale", 1)))
    n_class = ds.n_class

    cm = np.zeros((n_class, n_class), np.int64)
    files = sorted(glob.glob(os.path.join(rdir, "semantic_*.png")))
    if not files:
        raise SystemExit(f"no semantic renders found in {rdir}")
    for path in files:
        idx = int(os.path.basename(path)[9:-4])
        pred = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.int64)
        gt = ds[idx]["label"].astype(np.int64)
        cm += confusion_matrix(gt, pred, n_class)

    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(1)
    denom = tp + (cm.sum(0) - tp) + (support - tp)  # tp + fp + fn
    valid = (support > args.min_support) & (denom > 0)
    iou = np.where(denom > 0, tp / np.maximum(denom, 1), 0)
    result = {
        "miou": float(iou[valid].mean()),
        "total_acc": float(tp.sum() / max(cm.sum(), 1)),
        "n_valid_class": int(valid.sum()),
        "n_frames": len(files),
    }
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
