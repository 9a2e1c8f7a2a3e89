"""Isosurface extraction: vectorized marching tetrahedra.

Replaces the reference's ``skimage.measure.marching_cubes`` call (reference:
slams/meshing.py:661-672) — scikit-image isn't available here, and marching
tetrahedra needs no 256-case lookup table: each cube splits into 6 tets
around the 0-6 diagonal, and every tet contributes 0-2 triangles determined
by the 4 corner signs. Vertices lie on tet edges at linear-interpolated
crossings; since every tet edge is a segment between two grid points, welding
by (lo_id, hi_id) edge key yields a watertight shared-vertex mesh.

Triangle winding is made consistent by orienting each face against the local
field gradient (normals point from inside (value > level) to outside).

A C++ implementation (native/marching.cpp) is used when built — same
algorithm, ~10x faster on large grids; this numpy version is the reference
and fallback.

The port's own copy of dnsjax/mesh/marching.py, equal to it (the port imports nothing of
dnsjax; tests/test_torch_shared.py holds the two together).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# cube corner offsets, index = x + 2y + 4z ordering chosen s.t. diagonal 0-6
_CORNERS = np.array(
    [
        [0, 0, 0],  # 0
        [1, 0, 0],  # 1
        [1, 1, 0],  # 2
        [0, 1, 0],  # 3
        [0, 0, 1],  # 4
        [1, 0, 1],  # 5
        [1, 1, 1],  # 6
        [0, 1, 1],  # 7
    ],
    dtype=np.int64,
)

# 6-tet decomposition around the 0-6 diagonal (Bourke, "Polygonising a
# scalar field"): every tet contains corners 0 and 6.
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    dtype=np.int64,
)

# the 6 edges of a tet as (corner_a, corner_b) local indices
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)
_EDGE_OF = {(a, b): e for e, (a, b) in enumerate(_TET_EDGES)}
_EDGE_OF.update({(b, a): e for e, (a, b) in enumerate(_TET_EDGES)})


def _case_triangles(case: int):
    """Triangles (as triples of tet-edge ids) separating inside corners
    (bit set) from outside, for one of the 16 sign cases."""
    inside = [i for i in range(4) if case >> i & 1]
    outside = [i for i in range(4) if not case >> i & 1]
    if len(inside) == 0 or len(inside) == 4:
        return []
    if len(inside) == 3:
        inside, outside = outside, inside
    if len(inside) == 1:
        i = inside[0]
        j, k, l = outside
        return [(_EDGE_OF[(i, j)], _EDGE_OF[(i, k)], _EDGE_OF[(i, l)])]
    # two inside, two outside -> quad on 4 crossing edges
    i, j = inside
    k, l = outside
    e_ik, e_il = _EDGE_OF[(i, k)], _EDGE_OF[(i, l)]
    e_jk, e_jl = _EDGE_OF[(j, k)], _EDGE_OF[(j, l)]
    return [(e_ik, e_il, e_jk), (e_jk, e_il, e_jl)]


_CASE_TRIS = [_case_triangles(c) for c in range(16)]


def marching_tetrahedra(
    values: np.ndarray,
    level: float = 0.0,
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``values == level`` isosurface.

    Args:
      values: (Nx, Ny, Nz) scalar field ("inside" = value > level, matching
        occupancy-logit semantics with level_set 0).
      origin/spacing: world placement of grid point (i,j,k) =
        origin + (i,j,k) * spacing.
    Returns:
      (vertices (V, 3) float32, faces (F, 3) int32), deduplicated.
    """
    values = np.asarray(values, np.float64)
    nx, ny, nz = values.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # prefer the native C++ implementation (same algorithm, ~10x faster)
    from dnsjax_torch.mesh.native import marching_tetrahedra_native

    native = marching_tetrahedra_native(values, level, origin, spacing)
    if native is not None:
        return native

    # flat grid-point ids
    def pid(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    cx, cy, cz = nx - 1, ny - 1, nz - 1
    ix, iy, iz = np.meshgrid(
        np.arange(cx), np.arange(cy), np.arange(cz), indexing="ij"
    )
    base = np.stack([ix.ravel(), iy.ravel(), iz.ravel()], -1)  # (C, 3)

    # only keep cubes whose 8 corners straddle the level (big speedup)
    corner_vals = np.empty((base.shape[0], 8), np.float64)
    for c in range(8):
        o = _CORNERS[c]
        corner_vals[:, c] = values[
            base[:, 0] + o[0], base[:, 1] + o[1], base[:, 2] + o[2]
        ]
    straddle = ~(
        np.all(corner_vals <= level, 1) | np.all(corner_vals >= level, 1)
    )
    base = base[straddle]
    corner_vals = corner_vals[straddle]
    if base.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    corner_ids = np.empty((base.shape[0], 8), np.int64)
    for c in range(8):
        o = _CORNERS[c]
        corner_ids[:, c] = pid(
            base[:, 0] + o[0], base[:, 1] + o[1], base[:, 2] + o[2]
        )

    edge_keys = []  # (lo_id, hi_id) per emitted vertex slot
    tri_edges = []  # per triangle: 3 indices into the emitted slots
    tri_flip = []

    for t in range(6):
        tvtx = _TETS[t]
        vals = corner_vals[:, tvtx]  # (C, 4)
        ids = corner_ids[:, tvtx]  # (C, 4)
        case = (
            (vals[:, 0] > level).astype(np.int64)
            | (vals[:, 1] > level).astype(np.int64) << 1
            | (vals[:, 2] > level).astype(np.int64) << 2
            | (vals[:, 3] > level).astype(np.int64) << 3
        )
        for c in range(1, 15):
            sel = np.nonzero(case == c)[0]
            if sel.size == 0:
                continue
            for tri in _CASE_TRIS[c]:
                cols = []
                for e in tri:
                    a, b = _TET_EDGES[e]
                    ia, ib = ids[sel, a], ids[sel, b]
                    lo = np.minimum(ia, ib)
                    hi = np.maximum(ia, ib)
                    cols.append(np.stack([lo, hi], -1))
                edge_keys.append(np.concatenate(cols, 0))
                n = sel.size
                tri_edges.append(n)
                tri_flip.append(None)

    if not edge_keys:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    all_keys = np.concatenate(edge_keys, 0)  # (3 * F, 2) grouped per corner
    # reassemble per-triangle: each block in edge_keys holds [e0*n, e1*n, e2*n]
    faces_keys = []
    for block, n in zip(edge_keys, tri_edges):
        faces_keys.append(block.reshape(3, n, 2).transpose(1, 0, 2))
    fk = np.concatenate(faces_keys, 0)  # (F, 3, 2)

    # weld vertices by unique edge key
    flat = fk.reshape(-1, 2)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)

    # interpolate vertex positions on their grid edges
    vflat = values.ravel()
    va = vflat[uniq[:, 0]]
    vb = vflat[uniq[:, 1]]
    denom = vb - va
    tt = np.where(np.abs(denom) > 1e-12, (level - va) / np.where(denom == 0, 1, denom), 0.5)
    tt = np.clip(tt, 0.0, 1.0)

    def unflat(idv):
        izc = idv % nz
        iyc = (idv // nz) % ny
        ixc = idv // (ny * nz)
        return np.stack([ixc, iyc, izc], -1).astype(np.float64)

    pa = unflat(uniq[:, 0])
    pb = unflat(uniq[:, 1])
    verts = pa + tt[:, None] * (pb - pa)
    verts = np.asarray(origin, np.float64) + verts * np.asarray(spacing, np.float64)

    # consistent winding: orient faces so normals point from inside (>level)
    # toward outside, using the interpolation endpoints' values as a local
    # gradient proxy
    v0, v1, v2 = (verts[faces[:, k]] for k in range(3))
    nrm = np.cross(v1 - v0, v2 - v0)
    # gradient proxy at the face: mean direction from inside ends to outside
    enda = unflat(flat[:, 0]).reshape(-1, 3, 3) * np.asarray(spacing) + np.asarray(origin)
    endb = unflat(flat[:, 1]).reshape(-1, 3, 3) * np.asarray(spacing) + np.asarray(origin)
    va_f = vflat[flat[:, 0]].reshape(-1, 3)
    vb_f = vflat[flat[:, 1]].reshape(-1, 3)
    # vector pointing toward lower value (outside) per corner, averaged
    sgn = np.sign(va_f - vb_f)[..., None]  # + if a inside
    outward = ((endb - enda) * sgn).mean(axis=1)
    flip = np.einsum("ij,ij->i", nrm, outward) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    return verts.astype(np.float32), faces


def face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = (verts[faces[:, k]] for k in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-12)
