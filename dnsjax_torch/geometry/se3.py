"""Differentiable SE(3) / quaternion math, PyTorch port of dnsjax/geometry/se3.py.

Quaternions are (w, x, y, z); camera tensors are the 7-vector
``[qw, qx, qy, qz, tx, ty, tz]``; poses are camera-to-world 4x4 matrices.
Host bookkeeping of single poses uses the float64 numpy wrappers at the end.
"""

from __future__ import annotations

import numpy as np
import torch


def quat_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion (not necessarily unit) -> (..., 3, 3), with
    the ``2/|q|^2`` scaling so gradients flow through unnormalised quats."""
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sq = (q * q).sum(-1)
    # full_like, not a Python scalar: forward-mode AD of scalar / tensor
    # promotes the tangent to float64 in torch
    two_s = torch.full_like(sq, 2.0) / sq
    r = torch.stack(
        [
            1 - two_s * (qj**2 + qk**2),
            two_s * (qi * qj - qk * qr),
            two_s * (qi * qk + qj * qr),
            two_s * (qi * qj + qk * qr),
            1 - two_s * (qi**2 + qk**2),
            two_s * (qj * qk - qi * qr),
            two_s * (qi * qk - qj * qr),
            two_s * (qj * qk + qi * qr),
            1 - two_s * (qi**2 + qj**2),
        ],
        -1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotation_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 4) unit wxyz quaternion, w >= 0
    (branchless Shepperd: anchor on the largest diagonal magnitude)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    zero = torch.zeros_like(tr)
    qw2 = torch.maximum(zero, 1.0 + tr)
    qx2 = torch.maximum(zero, 1.0 + m00 - m11 - m22)
    qy2 = torch.maximum(zero, 1.0 - m00 + m11 - m22)
    qz2 = torch.maximum(zero, 1.0 - m00 - m11 + m22)
    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], -1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], -1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], -1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], -1)
    best = torch.stack([qw2, qx2, qy2, qz2], -1).argmax(-1)
    cands = torch.stack([cw, cx, cy, cz], -2)  # (..., 4 anchors, 4)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def compose_c2w(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    top = torch.cat([R, T[..., :, None]], -1)
    # a device op, not a host copy: a CUDA graph can capture it
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    bottom = bottom.expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


def camera_from_tensor(t: torch.Tensor) -> torch.Tensor:
    """7-vector [quat(wxyz), T] -> (..., 4, 4) c2w."""
    return compose_c2w(quat_to_rotation(t[..., :4]), t[..., 4:])


def tensor_from_camera(c2w: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) or (..., 3, 4) c2w -> 7-vector [quat, T]."""
    return torch.cat([rotation_to_quat(c2w[..., :3, :3]), c2w[..., :3, 3]], -1)


def invert_se3(M: torch.Tensor) -> torch.Tensor:
    """Invert a rigid 4x4 transform: [R t]^-1 = [R^T, -R^T t]."""
    Rt = M[..., :3, :3].transpose(-1, -2)
    t_inv = -(Rt @ M[..., :3, 3, None])[..., 0]
    return compose_c2w(Rt, t_inv)


# Host twins for per-frame pose bookkeeping (float64 numpy).
def camera_from_tensor_np(t) -> np.ndarray:
    return camera_from_tensor(torch.from_numpy(np.asarray(t, np.float64))).numpy()


def tensor_from_camera_np(c2w) -> np.ndarray:
    return tensor_from_camera(torch.from_numpy(np.asarray(c2w, np.float64))).numpy()
