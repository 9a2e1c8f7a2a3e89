"""The benchmark's reference: a frozen plain copy of dnsjax_torch/geometry/se3.py.

Differentiable SE(3) / quaternion math, PyTorch port of dnsjax/geometry/se3.py.

Quaternions are (w, x, y, z); camera tensors are the 7-vector
``[qw, qx, qy, qz, tx, ty, tz]``; poses are camera-to-world 4x4 matrices.
"""

from __future__ import annotations

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


def compose_c2w(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    top = torch.cat([R, T[..., :, None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


def invert_se3(M: torch.Tensor) -> torch.Tensor:
    """Invert a rigid 4x4 transform: [R t]^-1 = [R^T, -R^T t]."""
    Rt = M[..., :3, :3].transpose(-1, -2)
    t_inv = -(Rt @ M[..., :3, 3, None])[..., 0]
    return compose_c2w(Rt, t_inv)
