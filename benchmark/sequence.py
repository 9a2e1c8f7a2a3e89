"""Write an RGB-D semantic sequence of the rich room to disk in a dataset's
own layout, so that the port's loaders read it as they read a user's data.

``replica`` (the Semantic-NeRF renders of Replica that DNS-SLAM reads):
``rgb/rgb_{i}.png``, ``depth/depth_{i}.png`` (uint16 at ``png_depth_scale``),
``semantic_class/semantic_class_{i}.png`` and ``traj_w_c.txt`` (one
row-major 4x4 camera-to-world a line, OpenCV axes: y down, z forward).

``scannet``: ``color/{i}.jpg``, ``depth/{i}.png`` (uint16 at
``png_depth_scale``), ``label-filt/{i}.png`` (uint16 raw ids),
``pose/{i}.txt`` (a 4x4 camera-to-world, OpenCV axes) and
``scannetv2-labels.combined.tsv``, which maps each raw id (column 0) to its
NYU40 id (column 4).

Frames render on the given device from the seed; encoding and writing run
in a thread pool (OpenCV releases the interpreter lock while it encodes).
"""

from __future__ import annotations

import math
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import cv2
import numpy as np
import torch

from benchmark.scene import N_CLASS, RichScene, orbit_pose

# the scene's classes as ScanNet raw ids, and the NYU40 ids they map to
SCANNET_RAW_IDS = tuple(2 + 3 * k for k in range(N_CLASS))
SCANNET_NYU40 = tuple(1 + (7 * k) % 40 for k in range(N_CLASS))
PNG_FAST = [cv2.IMWRITE_PNG_COMPRESSION, 1]
JPEG_QUALITY = [cv2.IMWRITE_JPEG_QUALITY, 95]


def camera(fmt: str, cam: Dict[str, Any]) -> Dict[str, float]:
    """The intrinsics the frames are rendered with, before any crop: the
    Replica loader derives a 90-degree pinhole from the width; ScanNet's
    come from the configuration."""
    H, W = int(cam["H"]), int(cam["W"])
    if fmt == "replica":
        fx = W / 2.0 / math.tan(math.radians(45.0))
        return dict(H=H, W=W, fx=fx, fy=fx, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0)
    return dict(H=H, W=W, fx=float(cam["fx"]), fy=float(cam["fy"]), cx=float(cam["cx"]),
                cy=float(cam["cy"]))


def opencv_pose(c2w: np.ndarray) -> np.ndarray:
    """The file convention: columns 1 and 2 negated (the loaders negate them
    back)."""
    out = np.asarray(c2w, np.float64).copy()
    out[:3, 1] *= -1
    out[:3, 2] *= -1
    return out


def _pose_text(c2w: np.ndarray, rows: bool) -> str:
    m = opencv_pose(c2w)
    if rows:
        return "\n".join(" ".join(f"{v:.9g}" for v in r) for r in m) + "\n"
    return " ".join(f"{v:.9g}" for v in m.reshape(-1)) + "\n"


def _encode(frame: Dict[str, torch.Tensor], scale: float, lut: torch.Tensor):
    """Host arrays as the files hold them: BGR uint8, depth uint16 and the
    label image through ``lut`` (class -> raw id)."""
    rgb = torch.round(frame["color"] * 255.0).to(torch.uint8)
    depth = torch.round(frame["depth"] * scale).clamp(0, 65535).to(torch.int32)
    label = lut[frame["label"]]
    return (rgb.flip(-1).cpu().numpy(), depth.cpu().numpy().astype(np.uint16),
            label.cpu().numpy().astype(np.uint8 if int(lut.max()) < 256 else np.uint16))


def write_sequence(out_dir: str, fmt: str, cam: Dict[str, Any], n_frames: int, seed: int,
                   device="cpu", workers: int = 8) -> int:
    """Render ``n_frames`` frames of the orbit and write them under
    ``out_dir`` (emptied first) in ``fmt``; returns the bytes written."""
    if fmt not in ("replica", "scannet"):
        raise ValueError(f"format {fmt!r}: expected replica or scannet")
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    k = camera(fmt, cam)
    scene = RichScene(seed, k["H"], k["W"], k["fx"], k["fy"], k["cx"], k["cy"], device)
    scale = float(cam["png_depth_scale"])
    if fmt == "replica":
        dirs = ("rgb", "depth", "semantic_class")
        paths = lambda i: (f"rgb/rgb_{i}.png", f"depth/depth_{i}.png",
                           f"semantic_class/semantic_class_{i}.png")
        lut = torch.arange(N_CLASS, device=device)
    else:
        dirs = ("color", "depth", "label-filt", "pose")
        paths = lambda i: (f"color/{i}.jpg", f"depth/{i}.png", f"label-filt/{i}.png")
        lut = torch.as_tensor(SCANNET_RAW_IDS, device=device)
    for d in dirs:
        os.makedirs(os.path.join(out_dir, d))

    def write(i, bgr, depth, label):
        p_rgb, p_depth, p_label = (os.path.join(out_dir, p) for p in paths(i))
        ok = cv2.imwrite(p_rgb, bgr, JPEG_QUALITY if fmt == "scannet" else PNG_FAST)
        ok &= cv2.imwrite(p_depth, depth, PNG_FAST)
        ok &= cv2.imwrite(p_label, label, PNG_FAST)
        if fmt == "scannet":
            with open(os.path.join(out_dir, "pose", f"{i}.txt"), "w") as f:
                f.write(_pose_text(orbit_pose(i), rows=True))
        if not ok:
            raise OSError(f"could not write frame {i} under {out_dir}")

    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        for i in range(n_frames):
            pending.append(pool.submit(write, i, *_encode(scene.render(orbit_pose(i)), scale,
                                                          lut)))
            if len(pending) > 2 * workers:  # bound the frames held on the host
                pending.pop(0).result()
        for fut in pending:
            fut.result()
    if fmt == "replica":
        with open(os.path.join(out_dir, "traj_w_c.txt"), "w") as f:
            f.writelines(_pose_text(orbit_pose(i), rows=False) for i in range(n_frames))
    else:
        with open(os.path.join(out_dir, "scannetv2-labels.combined.tsv"), "w") as f:
            f.write("id\traw_category\tcategory\tcount\tnyu40id\teigen13id\tnyuClass\n")
            for k, (raw, nyu) in enumerate(zip(SCANNET_RAW_IDS, SCANNET_NYU40)):
                f.write(f"{raw}\tclass{k}\tclass{k}\t1\t{nyu}\t0\tclass{k}\n")
    return sum(os.path.getsize(os.path.join(r, n)) for r, _, ns in os.walk(out_dir) for n in ns)
