"""Additional coordinate encodings, PyTorch port of dnsjax/ops/encodings.py.

The SLAM pipeline uses OneBlob and the hash grid; the reference's encoder
factory also offers a dense grid, spherical harmonics, frequency and identity
encodings, and ``get_encoder`` dispatches over all of them as dnsjax's does.
``dense_grid_encode`` is ``hash_encode`` on a spec whose every level fits the
table, so each level is indexed densely; on the card it runs the encode
kernel (``csrc/hashgrid.cu``) through ``hash_encode``'s own dispatch.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from dnsjax_torch.ops.hashgrid import HashGridSpec, hash_encode, init_hash_table
from dnsjax_torch.ops.oneblob import oneblob_encode


def frequency_encode(pts: torch.Tensor, n_frequencies: int = 12) -> torch.Tensor:
    """NeRF-style frequency encoding: (..., D) -> (..., D * 2 * n_freq)."""
    freqs = 2.0 ** torch.arange(n_frequencies, dtype=pts.dtype, device=pts.device)
    ang = pts[..., None] * freqs * math.pi  # (..., D, F)
    out = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
    return out.reshape(pts.shape[:-1] + (pts.shape[-1] * 2 * n_frequencies,))


def identity_encode(pts: torch.Tensor) -> torch.Tensor:
    return pts


def spherical_harmonics_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical harmonics of unit directions up to ``degree`` bands
    (degree <= 4): (..., 3) -> (..., degree^2)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [0.28209479177387814 * torch.ones_like(x)]
    if degree > 1:
        comps += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if degree > 3:
        comps += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    return torch.stack(comps, -1)


def dense_grid_encode(table: torch.Tensor, pts: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Dense multi-level grid: ``hash_encode`` with every level required to
    fit the table (ValueError otherwise), so no level hashes."""
    for res in spec.level_resolutions():
        if (int(res) + 1) ** 3 > spec.table_size:
            raise ValueError(
                f"dense grid level res {res} exceeds table (use a bigger "
                "log2_hashmap_size)"
            )
    return hash_encode(table, pts, spec)


def get_encoder(
    encoding: str,
    input_dim: int = 3,
    degree: int = 4,
    n_bins: int = 16,
    n_frequencies: int = 12,
    n_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int = 512,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> Tuple[Callable, int, dict]:
    """The reference's encoder factory, dispatching as dnsjax's does.
    Returns (encode_fn, out_dim, params): params is {} for parameter-free
    encodings, {'table': (L, T, F) tensor on ``device``} for grids (default
    the card; ``device="cpu"`` for the CPU), drawn from ``generator``
    (default: a CPU generator seeded 0); encode_fn takes (params, pts).
    """
    e = encoding.lower()
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    if "dense" in e:
        # like the reference factory, the dense branch forces n_levels=4
        # whatever n_levels says
        spec = HashGridSpec(4, level_dim, log2_hashmap_size, base_resolution,
                            desired_resolution)
        table = init_hash_table(spec, generator, device)
        return lambda p, x: dense_grid_encode(p["table"], x, spec), spec.out_dim, {"table": table}
    if "hash" in e or "tiled" in e:
        spec = HashGridSpec(n_levels, level_dim, log2_hashmap_size,
                            base_resolution, desired_resolution)
        table = init_hash_table(spec, generator, device)
        return lambda p, x: hash_encode(p["table"], x, spec), spec.out_dim, {"table": table}
    if "spherical" in e:
        return lambda p, x: spherical_harmonics_encode(x, degree), degree**2, {}
    if "blob" in e:
        return lambda p, x: oneblob_encode(x, n_bins), input_dim * n_bins, {}
    if "freq" in e:
        return (lambda p, x: frequency_encode(x, n_frequencies),
                input_dim * 2 * n_frequencies, {})
    if "identity" in e:
        return lambda p, x: identity_encode(x), input_dim, {}
    raise ValueError(f"unknown encoding {encoding!r}")
