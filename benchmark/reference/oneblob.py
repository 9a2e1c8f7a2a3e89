"""The benchmark's reference: a frozen plain copy of dnsjax_torch/ops/oneblob.py.

OneBlob coordinate encoding, PyTorch port of dnsjax/ops/oneblob.py.

Each input coordinate in [0, 1] expands into ``n_bins`` features: the
integral of a kernel of scale 1/n_bins centred at the coordinate over each
of the n_bins equal sub-intervals of [0, 1]. Kernels: ``gaussian`` (erf CDF)
and ``quartic`` (K(t) = 15/16 (1 - t^2)^2 with half-width sqrt(7) sigma,
whose CDF is a quintic polynomial).
"""

from __future__ import annotations

import torch

_INV_SQRT2 = 0.7071067811865476


def linspace01(n: int, device=None) -> torch.Tensor:
    """float32 ``jnp.linspace(0, 1, n)`` bit for bit: i / (n - 1), then 1."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / float(n - 1)
    return torch.cat([t, torch.ones(1, device=device)])


def _quartic_cdf(t: torch.Tensor) -> torch.Tensor:
    """CDF of K(t) = 15/16 (1 - t^2)^2 on [-1, 1] (0 below, 1 above)."""
    tc = torch.clamp(t, -1.0, 1.0)
    tc2 = tc * tc
    return 0.9375 * (tc - (2.0 / 3.0) * (tc2 * tc) + 0.2 * (tc2 * tc2 * tc)) + 0.5


def oneblob_encode(pts: torch.Tensor, n_bins: int = 16, kernel: str = "gaussian") -> torch.Tensor:
    """(..., D) points in [0, 1] -> (..., D * n_bins) OneBlob features, in the
    flat layout (coordinate d's bins at [d*n_bins, (d+1)*n_bins))."""
    D = pts.shape[-1]
    sigma = 1.0 / n_bins
    edges = linspace01(n_bins + 1, pts.device).to(pts.dtype)
    x = pts.repeat_interleave(n_bins, dim=-1)
    lo = edges[:-1].repeat(D)
    hi = edges[1:].repeat(D)
    if kernel == "quartic":
        w = 2.6457513110645907 * sigma
        return _quartic_cdf((hi - x) / w) - _quartic_cdf((lo - x) / w)
    if kernel != "gaussian":
        raise ValueError(f"oneblob kernel={kernel!r}: expected gaussian|quartic")
    s = _INV_SQRT2 / sigma
    return 0.5 * (torch.erf((hi - x) * s) - torch.erf((lo - x) * s))
