"""The yardstick's arithmetic: model FLOPs of the SLAM loop's work counted
from the configuration's shapes, the bytes bounds of the two hand-written
kernels (copied from the port's ``chip_smoke.py``), and the table rows a
batch of points names (by the reference's frozen copy of the hash).

FLOPs count the matrix products only, 2 per multiply-add: the MLPs of the
map (forward; forward and backward where a gradient is taken) and the
frozen image encoder's convolution. A backward costs two forwards. The
peak they are held against is that of the configuration's compute dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from benchmark.reference.hashgrid import HashGridSpec, _corner_indices_weights


def _mlp(i: int, h: int, o: int) -> int:
    return 2 * (i * h + h * o)


def point_flops(cfg: Dict[str, Any], n_class: int, views: int, fine: bool) -> int:
    """Forward FLOPs of the map at one sample point: the coarse head (the
    fine one too when mapping), the merge MLP once per reference view, and
    the colour and logit heads."""
    m = cfg["model"]
    h, pe = int(m["hidden_dim"]), 3 * int(m["pos"]["n_bins"])
    grid = int(m["grid"]["n_levels"]) * int(m["grid"]["level_dim"])
    occ = _mlp(pe + grid, h, h + 1)
    return (occ * (2 if fine else 1) + views * _mlp(pe + int(m["pixel_dim"]), h, h)
            + _mlp(pe + 2 * h, h, 3) + _mlp(pe + 2 * h, h, n_class))


def image_flops(H: int, W: int) -> int:
    """The encoder's 7x7 stride-2 convolution, 3 -> 64 channels."""
    return 2 * 7 * 7 * 3 * 64 * ((H + 1) // 2) * ((W + 1) // 2)


def smooth_flops(cfg: Dict[str, Any]) -> int:
    """Forward FLOPs of one TV sub-grid evaluation (coarse head only)."""
    m = cfg["model"]
    h, pe = int(m["hidden_dim"]), 3 * int(m["pos"]["n_bins"])
    grid = int(m["grid"]["n_levels"]) * int(m["grid"]["level_dim"])
    g = int(cfg["training"]["smooth_pts"]) - 1
    return g ** 3 * _mlp(pe + grid, h, h + 1)


def keystep_flops(cfg: Dict[str, Any], n_class: int, H: int, W: int) -> int:
    """One keystep: ``n_iters`` iterations over the window's rays (forward
    and backward), the TV term on every ``smooth_every``-th, and the
    current frame's encoding."""
    mp, trn = cfg["mapping"], cfg["training"]
    T = int(mp["n_joint_optimize_frames"])
    n_pix = int(mp["n_pixels"]) // T
    rays = n_pix // 3 * 2 + n_pix // 3
    S = int(trn["n_samples_ray"]) + int(trn["n_surface_ray"])
    n_iters = int(mp["n_iters"]) // 2 * 2  # two outer calls of n_iters // 2
    every = max(int(trn.get("smooth_every", 1)), 1)
    per_iter = T * rays * S * point_flops(cfg, n_class, 3, fine=True)
    smooth = -(-n_iters // 2 // every) * 2 * smooth_flops(cfg)
    return 3 * (n_iters * per_iter + smooth) + image_flops(H, W)


def track_flops(cfg: Dict[str, Any], n_class: int, H: int, W: int, iters: int) -> int:
    """One tracked frame of ``iters`` Adam iterations, each a forward and a
    backward over the frame's rays, and the two images it encodes."""
    tr, trn = cfg["tracking"], cfg["training"]
    pts = int(tr["n_pixels"]) * (int(trn["n_samples_ray"]) + int(trn["n_surface_ray"]))
    fwd = pts * point_flops(cfg, n_class, 2, fine=False)
    return 3 * fwd * iters + 2 * image_flops(H, W)


def peak_flops(cfg: Dict[str, Any], peaks: Dict[str, Any]) -> float:
    """The card's dense peak in the configuration's compute dtype."""
    dtype = (cfg.get("tpu") or {}).get("compute_dtype", "bfloat16")
    return float(peaks["bf16_dense_flops" if dtype == "bfloat16" else "fp32_flops"])


def decoder_init_flops(cfg: Dict[str, Any], n_class: int, iters: int = 100,
                       rays: int = 300) -> int:
    """A warm-up of new class decoders: ``iters`` iterations of ``rays``
    rays of one view and the TV term, forward and backward."""
    trn = cfg["training"]
    S = int(trn["n_samples_ray"]) + int(trn["n_surface_ray"])
    return 3 * iters * (rays * S * point_flops(cfg, n_class, 1, fine=True) + smooth_flops(cfg))


def encode_bytes(spec: HashGridSpec, N: int, want_res: bool, unique_rows: int) -> int:
    """pts 12 B and out L*F*4 B a point; with the residuals also feats
    L*C*F*4, idx and w L*C*4 each, aux L*3*4; plus, once, each table row
    that a corner of these points names, F*4 B (``chip_smoke._encode_bytes``)."""
    L, C, F = spec.n_levels, spec.n_corners, spec.n_features
    per_point = 12 + 4 * L * F + (4 * L * (C * F + 2 * C + 3) if want_res else 0)
    return N * per_point + unique_rows * 4 * F


def encode_backward_bytes(spec: HashGridSpec, N: int, position: bool) -> int:
    """The encode's backward: the table gradient (idx and w 4 B a corner, g
    4F B a (point, level), the table once: ``chip_smoke._table_grad_bytes``)
    and, where the points need a gradient, the position gradient (pts,
    the saved corner rows feats and aux and g read, d_pts written)."""
    L, C, F, T = spec.n_levels, spec.n_corners, spec.n_features, spec.table_size
    table = N * L * (8 * C + 4 * F) + L * T * F * 4
    pos = N * (12 + 4 * L * (C * F + 3 + F) + 12) if position else 0
    return table + pos


def unique_rows(spec: HashGridSpec, pts01: torch.Tensor) -> int:
    """Distinct table rows that the corners of ``pts01`` (N, 3) name."""
    idx, _, _ = _corner_indices_weights(torch.clamp(pts01.float(), 0.0, 1.0), spec)
    return int(torch.unique(idx).numel())
