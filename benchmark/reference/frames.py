"""The benchmark's reference: its own reading of the sequences that
``benchmark/sequence.py`` writes, as the datasets define them.

Replica: RGB PNG, depth PNG over ``png_depth_scale`` metres, class PNG; a
90-degree pinhole derived from the width. ScanNet: JPEG colour resized to the
depth image, depth PNG, raw label ids mapped to NYU40 through the label TSV;
the intrinsics of the configuration; ``crop_edge`` pixels cut off each
side. Both compact their labels to class ids in the order the classes first
appear in every fifth frame (each frame's ids ascending), as DNS-SLAM does.
"""

from __future__ import annotations

import csv
import glob
import math
import os
from typing import Any, Dict

import cv2
import numpy as np


class Frames:
    def __init__(self, folder: str, fmt: str, cam: Dict[str, Any]):
        self.folder, self.fmt = folder, fmt
        self.scale = float(cam["png_depth_scale"])
        H, W = int(cam["H"]), int(cam["W"])
        self.edge = int(cam.get("crop_edge", 0)) if fmt == "scannet" else 0
        if fmt == "replica":
            fx = W / 2.0 / math.tan(math.radians(45.0))
            fy, cx, cy = fx, (W - 1) / 2.0, (H - 1) / 2.0
            self.n = len(glob.glob(os.path.join(folder, "rgb", "rgb_*.png")))
            self.canonical = {}
        else:
            fx, fy, cx, cy = (float(cam[k]) for k in ("fx", "fy", "cx", "cy"))
            self.n = len(glob.glob(os.path.join(folder, "color", "*.jpg")))
            with open(os.path.join(folder, "scannetv2-labels.combined.tsv"), newline="") as f:
                rows = list(csv.reader(f, delimiter="\t"))[1:]
            self.canonical = {int(r[0]): int(r[4]) for r in rows}
        e = self.edge
        self.cam = dict(H=H - 2 * e, W=W - 2 * e, fx=fx, fy=fy, cx=cx - e, cy=cy - e)
        self.class_of: Dict[int, int] = {}
        for i in range(0, self.n, 5):
            for v in np.unique(self._raw_label(i)).tolist():
                v = self._canon(v)
                if v not in self.class_of:
                    self.class_of[v] = len(self.class_of)
        self.n_class = len(self.class_of)

    def _canon(self, v: int) -> int:
        return self.canonical.get(v, 0) if self.fmt == "scannet" else v

    def _paths(self, i: int):
        if self.fmt == "replica":
            return (f"rgb/rgb_{i}.png", f"depth/depth_{i}.png",
                    f"semantic_class/semantic_class_{i}.png")
        return f"color/{i}.jpg", f"depth/{i}.png", f"label-filt/{i}.png"

    def _raw_label(self, i: int) -> np.ndarray:
        return cv2.imread(os.path.join(self.folder, self._paths(i)[2]), cv2.IMREAD_UNCHANGED)

    def frame(self, i: int) -> Dict[str, np.ndarray]:
        """color (H, W, 3) float32 in [0, 1], depth (H, W) float32 metres,
        label (H, W) int32 class ids, after the crop."""
        p_rgb, p_depth, _ = (os.path.join(self.folder, p) for p in self._paths(i))
        depth = cv2.imread(p_depth, cv2.IMREAD_UNCHANGED).astype(np.float32) / self.scale
        bgr = cv2.imread(p_rgb, cv2.IMREAD_COLOR)
        color = bgr[..., ::-1].astype(np.float32) / 255.0
        H, W = depth.shape
        if color.shape[:2] != (H, W):
            color = cv2.resize(color, (W, H))
        raw = self._raw_label(i)
        label = np.zeros(raw.shape, np.int32)
        for v in np.unique(raw).tolist():
            label[raw == v] = self.class_of.get(self._canon(v), 0)
        e = self.edge
        if e:
            color, depth, label = color[e:-e, e:-e], depth[e:-e, e:-e], label[e:-e, e:-e]
        return {"color": np.ascontiguousarray(color), "depth": np.ascontiguousarray(depth),
                "label": np.ascontiguousarray(label)}
