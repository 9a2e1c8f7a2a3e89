"""dnsjax's host-side mesh code, shared without importing jax.

``dnsjax/mesh/{export,native,marching}.py`` import only numpy and the
standard library, but their package's ``__init__`` imports dnsjax's jax
mesher, and ``marching_tetrahedra`` imports ``dnsjax.mesh.native`` through
that package. So the three files are loaded here from their paths, under
private module names (nothing is registered under ``dnsjax.*``), and
``marching_tetrahedra``'s wrapper and numpy fallback are carried over: the
native library first (``native/marching.cpp``, built with g++ at first use
into ``native/libmarching.so``, as dnsjax builds it), else the same
algorithm in numpy.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Tuple

import numpy as np

_MESH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "dnsjax", "mesh")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_dnsjax_mesh_{name}", os.path.join(_MESH_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


export = _load("export")
native = _load("native")
_mt = _load("marching")
write_ply = export.write_ply
read_ply = export.read_ply


def native_loaded() -> bool:
    """Whether the native marching library builds and loads here."""
    return native.load() is not None


def marching_tetrahedra(values: np.ndarray, level: float = 0.0, origin=(0.0, 0.0, 0.0),
                        spacing=(1.0, 1.0, 1.0)) -> Tuple[np.ndarray, np.ndarray]:
    """dnsjax.mesh.marching.marching_tetrahedra: the ``values == level``
    isosurface ("inside" = value > level) as (vertices (V, 3) float32, faces
    (F, 3) int32), grid point (i, j, k) at origin + (i, j, k) * spacing."""
    values = np.asarray(values, np.float64)
    nx, ny, nz = values.shape
    empty = np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    if min(nx, ny, nz) < 2:
        return empty
    out = native.marching_tetrahedra_native(values, level, origin, spacing)
    if out is not None:
        return out

    def pid(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    ix, iy, iz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
                             indexing="ij")
    base = np.stack([ix.ravel(), iy.ravel(), iz.ravel()], -1)
    corner_vals = np.empty((base.shape[0], 8), np.float64)
    for c, o in enumerate(_mt._CORNERS):
        corner_vals[:, c] = values[base[:, 0] + o[0], base[:, 1] + o[1], base[:, 2] + o[2]]
    straddle = ~(np.all(corner_vals <= level, 1) | np.all(corner_vals >= level, 1))
    base, corner_vals = base[straddle], corner_vals[straddle]
    if base.shape[0] == 0:
        return empty
    corner_ids = np.stack([pid(base[:, 0] + o[0], base[:, 1] + o[1], base[:, 2] + o[2])
                           for o in _mt._CORNERS], -1)

    faces_keys = []  # per triangle, the (lo, hi) grid-point keys of its 3 edges
    for tvtx in _mt._TETS:
        vals, ids = corner_vals[:, tvtx], corner_ids[:, tvtx]
        case = sum((vals[:, k] > level).astype(np.int64) << k for k in range(4))
        for c in range(1, 15):
            sel = np.nonzero(case == c)[0]
            for tri in (_mt._CASE_TRIS[c] if sel.size else ()):
                cols = []
                for e in tri:
                    a, b = _mt._TET_EDGES[e]
                    ia, ib = ids[sel, a], ids[sel, b]
                    cols.append(np.stack([np.minimum(ia, ib), np.maximum(ia, ib)], -1))
                faces_keys.append(np.stack(cols, 1))  # (n, 3, 2)
    if not faces_keys:
        return empty

    flat = np.concatenate(faces_keys, 0).reshape(-1, 2)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    vflat = values.ravel()
    va, vb = vflat[uniq[:, 0]], vflat[uniq[:, 1]]
    denom = vb - va
    tt = np.where(np.abs(denom) > 1e-12, (level - va) / np.where(denom == 0, 1, denom), 0.5)
    tt = np.clip(tt, 0.0, 1.0)

    def unflat(idv):
        return np.stack([idv // (ny * nz), (idv // nz) % ny, idv % nz], -1).astype(np.float64)

    org, spc = np.asarray(origin, np.float64), np.asarray(spacing, np.float64)
    pa, pb = unflat(uniq[:, 0]), unflat(uniq[:, 1])
    verts = org + (pa + tt[:, None] * (pb - pa)) * spc

    # orient faces so normals point from inside (> level) to outside
    v0, v1, v2 = (verts[faces[:, k]] for k in range(3))
    nrm = np.cross(v1 - v0, v2 - v0)
    enda = unflat(flat[:, 0]).reshape(-1, 3, 3) * spc + org
    endb = unflat(flat[:, 1]).reshape(-1, 3, 3) * spc + org
    sgn = np.sign(vflat[flat[:, 0]] - vflat[flat[:, 1]]).reshape(-1, 3)[..., None]
    outward = ((endb - enda) * sgn).mean(axis=1)
    flip = np.einsum("ij,ij->i", nrm, outward) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts.astype(np.float32), faces
