"""Pixel sampling (uniform and class-balanced), PyTorch port of dnsjax/slam/sampling.py.

Each sampler takes its uniform draws as input or draws them from a
``torch.Generator``; the class-balanced sampler selects pixels exactly as
the reference does given the same uniforms.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def class_sorted_pixels(label: np.ndarray, n_class: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host preprocessing: (H*W,) pixel ids sorted by class (stable), and
    (n_class + 1,) prefix offsets (class c at sorted[offsets[c]:offsets[c+1]])."""
    flat = np.asarray(label).reshape(-1)
    sorted_idx = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=n_class)
    offsets = np.zeros(n_class + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    return sorted_idx, offsets


def sample_uniform_pixels(generator: torch.Generator, n: int, H: int, W: int,
                          edge_h: int = 0, edge_w: int = 0, batch: tuple = (),
                          device="cpu") -> torch.Tensor:
    """(*batch, n) flat pixel ids uniform (with replacement) over the inner
    crop [edge_h, H-edge_h) x [edge_w, W-edge_w)."""
    shape = tuple(batch) + (n,)
    j = torch.randint(edge_h, H - edge_h, shape, generator=generator, device=device)
    i = torch.randint(edge_w, W - edge_w, shape, generator=generator, device=device)
    return j * W + i


def sample_class_balanced_pixels(u: torch.Tensor, sorted_idx: torch.Tensor,
                                 offsets: torch.Tensor) -> torch.Tensor:
    """Class-balanced pixel ids from uniforms ``u`` (..., n): slot s draws
    from the (s mod n_present)-th class present in the frame.
    sorted_idx (..., H*W), offsets (..., C+1)."""
    n = u.shape[-1]
    offsets = offsets.to(torch.int64)
    counts = offsets[..., 1:] - offsets[..., :-1]
    present = (counts > 0).to(torch.int64)
    n_present = torch.clamp(present.sum(-1, keepdim=True), min=1)
    cum = torch.cumsum(present, -1).contiguous()
    ranks = torch.arange(n, device=u.device) % n_present
    cls = torch.searchsorted(cum, (ranks + 1).contiguous(), side="left")
    lo = torch.gather(offsets, -1, cls)
    cnt = torch.clamp(torch.gather(counts, -1, cls), min=1)
    pick = lo + (u * cnt.to(u.dtype)).to(torch.int64)
    return torch.gather(sorted_idx.to(torch.int64), -1, pick)


def sample_restricted_class_pixels(u: torch.Tensor, sorted_idx: torch.Tensor,
                                   offsets: torch.Tensor,
                                   class_mask: torch.Tensor) -> torch.Tensor:
    """Class-balanced pixel ids from uniforms ``u`` (n,), restricted to the
    classes of ``class_mask`` (C,) bool that the frame shows (the decoder
    warm-up's rays); when it matches none, all present classes. sorted_idx
    (H*W,), offsets (C+1,)."""
    offsets = offsets.to(torch.int64)
    counts = offsets[1:] - offsets[:-1]
    present = (counts > 0) & class_mask.to(torch.bool)
    present = torch.where(present.any(), present, counts > 0).to(torch.int64)
    n_present = torch.clamp(present.sum(), min=1)
    cum = torch.cumsum(present, 0)
    ranks = torch.arange(u.shape[0], device=u.device) % n_present
    cls = torch.searchsorted(cum, ranks + 1, side="left")
    cnt = torch.clamp(counts[cls], min=1)
    pick = offsets[cls] + (u * cnt.to(u.dtype)).to(torch.int64)
    return sorted_idx.to(torch.int64)[pick]
