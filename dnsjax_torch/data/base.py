"""Dataset layer: RGB-D(+semantic) sequence readers.

Host-side numpy counterpart of the reference's torch Datasets (reference:
datas/slam_datasets.py). Frames are returned as numpy arrays (color float32
[H,W,3] in [0,1], depth float32 [H,W] in meters, label int32 [H,W] compacted
class ids, c2w float32 [4,4]); the SLAM loop moves them to the device.

Pose conventions match the reference: stored c2w matrices have columns 1 and
2 negated (OpenGL-style -z-forward camera), and pose translations are scaled
by ``scale`` (slam_datasets.py:143-144, 259-269).

The port's own copy of dnsjax/data/base.py, equal to it (the port imports nothing of
dnsjax; tests/test_torch_shared.py holds the two together).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover - cv2 is a dependency of the readers
    cv2 = None


class BaseDataset:
    """Shared frame-loading logic (reference: slam_datasets.py:64-149)."""

    name = "base"
    semantic = True

    def __init__(self, cfg: Dict[str, Any], input_folder: str, scale: float = 1.0):
        cam = cfg["cam"]
        self.scale = float(scale)
        self.png_depth_scale = float(cam["png_depth_scale"])
        self.crop_edge = int(cam.get("crop_edge", 0))
        self.crop_size = cam.get("crop_size")
        self.distortion = (
            np.asarray(cam["distortion"], np.float64) if "distortion" in cam else None
        )
        self.input_folder = input_folder

        self.H = int(cam["H"])
        self.W = int(cam["W"])
        self.fx = float(cam["fx"])
        self.fy = float(cam["fy"])
        self.cx = float(cam["cx"])
        self.cy = float(cam["cy"])

        self.n_img = 0
        self.poses: list = []
        self.label2class_dict: Dict[int, int] = {}
        self.class2label_dict: Dict[int, int] = {}
        self.n_class = 0

    # -- paths, provided by subclasses ------------------------------------
    def _color_path(self, index: int) -> str:
        raise NotImplementedError

    def _depth_path(self, index: int) -> str:
        raise NotImplementedError

    def _label_path(self, index: int) -> Optional[str]:
        raise NotImplementedError

    def _map_labels(self, label: np.ndarray) -> np.ndarray:
        """Raw label image -> compacted class ids."""
        lut_src = self.label2class_dict
        out = np.zeros_like(label, dtype=np.int32)
        # vectorized dict map: build a lut over the value range seen
        uniq = np.unique(label)
        for v in uniq:
            out[label == v] = lut_src.get(int(v), 0)
        return out

    def update_cam_for_crop(self) -> None:
        """Adjust intrinsics for crop_size / crop_edge (reference:
        slams/dns_slam.py:110-132 ``update_cam``). Keeps a copy of the raw
        intrinsics: undistortion happens on the raw full-resolution image,
        so it must use the pre-crop K."""
        self._raw_intrinsics = (self.fx, self.fy, self.cx, self.cy)
        if self.crop_size is not None:
            ch, cw = int(self.crop_size[0]), int(self.crop_size[1])
            sx = cw / self.W
            sy = ch / self.H
            self.fx *= sx
            self.fy *= sy
            self.cx *= sx
            self.cy *= sy
            self.W, self.H = cw, ch
        if self.crop_edge > 0:
            self.H -= 2 * self.crop_edge
            self.W -= 2 * self.crop_edge
            self.cx -= self.crop_edge
            self.cy -= self.crop_edge

    def __len__(self) -> int:
        return self.n_img

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        color = cv2.imread(self._color_path(index))
        if self.distortion is not None:
            fx, fy, cx, cy = getattr(
                self, "_raw_intrinsics", (self.fx, self.fy, self.cx, self.cy)
            )
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
            color = cv2.undistort(color, K, self.distortion)
        color = cv2.cvtColor(color, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0

        dp = self._depth_path(index)
        if dp.endswith(".exr"):
            # reference: slam_datasets.py:102-103 + datas/common.py:23-56;
            # note it applies png_depth_scale to EXR depth too (line 112)
            from dnsjax_torch.data.exr import read_exr_depth

            depth = read_exr_depth(dp)
        else:
            depth = cv2.imread(dp, cv2.IMREAD_UNCHANGED)
        depth = depth.astype(np.float32) / self.png_depth_scale * self.scale
        H, W = depth.shape
        color = cv2.resize(color, (W, H))

        label = None
        if self.semantic:
            lp = self._label_path(index)
            raw = cv2.imread(lp, cv2.IMREAD_UNCHANGED)
            raw = cv2.resize(
                raw.astype(np.float32), (W, H), interpolation=cv2.INTER_NEAREST
            ).astype(np.int64)
            label = self._map_labels(raw)

        if self.crop_size is not None:
            ch, cw = int(self.crop_size[0]), int(self.crop_size[1])
            color = cv2.resize(color, (cw, ch), interpolation=cv2.INTER_LINEAR)
            depth = cv2.resize(depth, (cw, ch), interpolation=cv2.INTER_NEAREST)
            if label is not None:
                label = cv2.resize(
                    label.astype(np.float32), (cw, ch), interpolation=cv2.INTER_NEAREST
                ).astype(np.int32)

        e = self.crop_edge
        if e > 0:
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
            if label is not None:
                label = label[e:-e, e:-e]

        pose = self.poses[index].copy()
        pose[:3, 3] *= self.scale

        return {
            "index": index,
            "color": np.ascontiguousarray(color, np.float32),
            "depth": np.ascontiguousarray(depth, np.float32),
            "label": (
                np.ascontiguousarray(label, np.int32)
                if label is not None
                else np.zeros_like(depth, np.int32)
            ),
            "c2w": pose.astype(np.float32),
        }

    def compact_classes(self, stride: int = 5) -> None:
        """Scan every ``stride``-th label frame and build the label<->class
        maps (reference: slam_datasets.py:271-287)."""
        self.label2class_dict = {}
        self.class2label_dict = {}
        n = 0
        for i in range(0, self.n_img, stride):
            raw = cv2.imread(self._label_path(i), cv2.IMREAD_UNCHANGED)
            for v in np.unique(raw):
                v = self._raw_to_canonical(int(v))
                if v not in self.label2class_dict:
                    self.label2class_dict[v] = n
                    self.class2label_dict[n] = v
                    n += 1
        self.n_class = n

    def _raw_to_canonical(self, value: int) -> int:
        """Raw png value -> canonical label space (identity for Replica,
        raw->NYU40 for ScanNet)."""
        return value


class Replica(BaseDataset):
    """Replica sequences (reference: slam_datasets.py:231-287)."""

    name = "replica"

    def __init__(self, cfg, input_folder, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        # hfov-90 pinhole intrinsics derived from W
        self.hfov = 90.0
        self.fx = self.W / 2.0 / math.tan(math.radians(self.hfov / 2.0))
        self.fy = self.fx
        self.cx = (self.W - 1.0) / 2.0
        self.cy = (self.H - 1.0) / 2.0

        import glob

        self.color_paths = sorted(glob.glob(f"{input_folder}/rgb/rgb_*.png"))
        self.n_img = len(self.color_paths)
        self._load_poses(f"{input_folder}/traj_w_c.txt")
        self.compact_classes()
        self.update_cam_for_crop()

    def _color_path(self, i):
        return f"{self.input_folder}/rgb/rgb_{i}.png"

    def _depth_path(self, i):
        return f"{self.input_folder}/depth/depth_{i}.png"

    def _label_path(self, i):
        return f"{self.input_folder}/semantic_class/semantic_class_{i}.png"

    def _load_poses(self, path):
        self.poses = []
        with open(path) as f:
            lines = f.readlines()
        for i in range(self.n_img):
            c2w = np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            c2w[:3, 1] *= -1
            c2w[:3, 2] *= -1
            self.poses.append(c2w.astype(np.float32))


class ScanNet(BaseDataset):
    """ScanNet sequences with raw->NYU40 label mapping (reference:
    slam_datasets.py:153-228)."""

    name = "scannet"

    def __init__(self, cfg, input_folder, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        import csv
        import glob

        self.color_paths = sorted(
            glob.glob(os.path.join(input_folder, "color", "*.jpg")),
            key=lambda x: int(os.path.basename(x)[:-4]),
        )
        self.n_img = len(self.color_paths)

        self.id_map: Dict[int, int] = {}
        tsv = os.path.join(input_folder, "scannetv2-labels.combined.tsv")
        with open(tsv, newline="", encoding="utf-8") as f:
            reader = csv.reader(f, delimiter="\t")
            next(reader)
            for row in reader:
                self.id_map[int(row[0])] = int(row[4])

        self._load_poses(os.path.join(input_folder, "pose"))
        self.compact_classes()
        self.update_cam_for_crop()

    def _raw_to_canonical(self, value):
        return self.id_map.get(value, 0)

    def _map_labels(self, label):
        out = np.zeros_like(label, dtype=np.int32)
        for v in np.unique(label):
            nyu = self.id_map.get(int(v), 0)
            out[label == v] = self.label2class_dict.get(nyu, 0)
        return out

    def _color_path(self, i):
        return f"{self.input_folder}/color/{i}.jpg"

    def _depth_path(self, i):
        return f"{self.input_folder}/depth/{i}.png"

    def _label_path(self, i):
        return f"{self.input_folder}/label-filt/{i}.png"

    def _load_poses(self, path):
        import glob

        self.poses = []
        for p in sorted(
            glob.glob(os.path.join(path, "*.txt")),
            key=lambda x: int(os.path.basename(x)[:-4]),
        ):
            with open(p) as f:
                c2w = np.array(
                    [list(map(float, l.split())) for l in f.readlines()]
                ).reshape(4, 4)
            c2w[:3, 1] *= -1
            c2w[:3, 2] *= -1
            self.poses.append(c2w.astype(np.float32))


class TUM_RGBD(BaseDataset):
    """TUM RGB-D (timestamp association, no semantics; reference:
    slam_datasets.py:290-378). Registered here unlike the reference, which
    defines but never registers it."""

    name = "tum"
    semantic = False

    def __init__(self, cfg, input_folder, scale=1.0, frame_rate=32):
        super().__init__(cfg, input_folder, scale)
        self.color_paths, self.depth_paths, self.poses = self._load_tum(
            input_folder, frame_rate
        )
        self.n_img = len(self.color_paths)
        self.n_class = 1
        self.label2class_dict = {0: 0}
        self.class2label_dict = {0: 0}
        self.update_cam_for_crop()

    def _color_path(self, i):
        return self.color_paths[i]

    def _depth_path(self, i):
        return self.depth_paths[i]

    def _label_path(self, i):
        return None

    @staticmethod
    def _parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_, skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        assoc = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                assoc.append((i, j, k))
        return assoc

    def _load_tum(self, datapath, frame_rate):
        from scipy.spatial.transform import Rotation

        pose_list = os.path.join(datapath, "groundtruth.txt")
        if not os.path.isfile(pose_list):
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_depth, t_pose)

        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        images, depths, poses = [], [], []
        inv_pose = None
        for ix in indices:
            i, j, k = assoc[ix]
            images.append(os.path.join(datapath, image_data[i, 1]))
            depths.append(os.path.join(datapath, depth_data[j, 1]))
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(pose_vecs[k][3:]).as_matrix()
            c2w[:3, 3] = pose_vecs[k][:3]
            if inv_pose is None:
                inv_pose = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_pose @ c2w
            c2w[:3, 1] *= -1
            c2w[:3, 2] *= -1
            poses.append(c2w.astype(np.float32))
        return images, depths, poses


def get_dataset(cfg: Dict[str, Any], input_folder: str, scale: float = 1.0):
    """Registry (reference: slam_datasets.py:381-384, + tum + synthetic)."""
    from dnsjax_torch.data.synthetic import SyntheticDataset

    registry = {
        "replica": Replica,
        "scannet": ScanNet,
        "tum": TUM_RGBD,
        "synthetic": SyntheticDataset,
    }
    return registry[cfg["dataset"]](cfg, input_folder, scale)
