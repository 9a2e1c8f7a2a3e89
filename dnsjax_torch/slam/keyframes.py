"""Fixed-capacity on-device keyframe store, PyTorch port of dnsjax/slam/keyframes.py.

Preallocated tensors of capacity ``max_keyframes`` on the compute device;
per-frame class-sorted pixel ids are computed once at insertion on the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from dnsjax_torch.slam.sampling import class_sorted_pixels


class KeyframeStore:
    def __init__(self, capacity: int, H: int, W: int, n_class: int, device="cpu"):
        self.capacity = capacity
        self.H, self.W = H, W
        self.n_class = n_class
        self.count = 0
        self.frame_ids: List[int] = []
        self.device = device
        z = dict(device=device)
        self.colors = torch.zeros((capacity, H, W, 3), **z)
        self.depths = torch.zeros((capacity, H, W), **z)
        self.labels = torch.zeros((capacity, H, W), dtype=torch.int32, **z)
        self.gt_c2w = torch.eye(4, **z).repeat(capacity, 1, 1)
        self.est_c2w = torch.eye(4, **z).repeat(capacity, 1, 1)
        self.sorted_idx = torch.zeros((capacity, H * W), dtype=torch.int32, **z)
        self.class_offsets = torch.zeros((capacity, n_class + 1), dtype=torch.int32, **z)

    def add(self, frame: Dict[str, np.ndarray], est_c2w) -> int:
        """Insert a keyframe (host arrays ``color``, ``depth``, ``label``,
        ``c2w``, ``index``); returns its slot."""
        if self.count >= self.capacity:
            raise RuntimeError(
                f"keyframe store full ({self.capacity}); raise mapping.max_keyframes"
            )
        k = self.count
        sorted_idx, offsets = class_sorted_pixels(frame["label"], self.n_class)
        dev = self.device
        self.colors[k] = torch.as_tensor(np.asarray(frame["color"], np.float32), device=dev)
        self.depths[k] = torch.as_tensor(np.asarray(frame["depth"], np.float32), device=dev)
        self.labels[k] = torch.as_tensor(np.asarray(frame["label"], np.int32), device=dev)
        self.gt_c2w[k] = torch.as_tensor(np.asarray(frame["c2w"], np.float32), device=dev)
        self.est_c2w[k] = torch.as_tensor(np.asarray(est_c2w, np.float32), device=dev)
        self.sorted_idx[k] = torch.as_tensor(sorted_idx, device=dev)
        self.class_offsets[k] = torch.as_tensor(offsets, device=dev)
        self.frame_ids.append(int(frame["index"]))
        self.count += 1
        return k

    def update_pose(self, slot: int, est_c2w: torch.Tensor) -> None:
        """Write back a BA-refined pose."""
        self.est_c2w[slot] = est_c2w

    def evict(self, slot: int) -> None:
        """Remove a keyframe, shifting later slots down (slot order stays
        insertion order)."""
        if not (0 <= slot < self.count):
            raise IndexError(f"evict slot {slot} out of range (count {self.count})")
        K = self.count
        for name in ("colors", "depths", "labels", "gt_c2w", "est_c2w",
                     "sorted_idx", "class_offsets"):
            arr = getattr(self, name)
            arr[slot:K - 1] = arr[slot + 1:K].clone()
        del self.frame_ids[slot]
        self.count -= 1
