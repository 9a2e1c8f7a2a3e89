"""Binary PLY export (replaces the reference's trimesh dependency;
reference export call sites: slams/meshing.py:769-826).

The port's own copy of dnsjax/mesh/export.py, equal to it (the port imports nothing of
dnsjax; tests/test_torch_shared.py holds the two together).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def write_ply(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
) -> None:
    """Write a binary little-endian PLY.

    colors: optional (V, 3) float in [0,1] or uint8.
    labels: optional (V,) int -> stored as ushort property 'label'.
    """
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    V = vertices.shape[0]
    F = faces.shape[0]

    props = ["property float x", "property float y", "property float z"]
    vdtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        props += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
        vdtype += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if labels is not None:
        labels = np.asarray(labels)
        props.append("property ushort label")
        vdtype.append(("label", "<u2"))

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {V}\n" + "\n".join(props) + "\n"
        f"element face {F}\nproperty list uchar int vertex_indices\n"
        "end_header\n"
    )

    vbuf = np.empty(V, dtype=vdtype)
    vbuf["x"], vbuf["y"], vbuf["z"] = vertices.T
    if colors is not None:
        vbuf["red"], vbuf["green"], vbuf["blue"] = colors.T
    if labels is not None:
        vbuf["label"] = labels.astype("<u2")

    fbuf = np.empty(F, dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    fbuf["n"] = 3
    fbuf["idx"] = faces

    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vbuf.tobytes())
        f.write(fbuf.tobytes())


def read_ply(path: str):
    """Minimal PLY reader for our own files (used by eval_3d/cull_mesh and
    tests). Returns (vertices, faces, colors or None, labels or None)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = f.readline().strip()
        assert b"binary_little_endian" in fmt, "only binary PLY supported"
        n_vert = n_face = 0
        vprops = []
        element = None
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "element":
                element = parts[1]
                if element == "vertex":
                    n_vert = int(parts[2])
                else:
                    n_face = int(parts[2])
            elif parts[0] == "property" and element == "vertex":
                vprops.append((parts[2], parts[1]))
        tmap = {"float": "<f4", "uchar": "u1", "ushort": "<u2", "int": "<i4"}
        vdtype = [(name, tmap[t]) for name, t in vprops]
        vbuf = np.frombuffer(f.read(n_vert * np.dtype(vdtype).itemsize), vdtype)
        fdtype = [("n", "u1"), ("idx", "<i4", (3,))]
        fbuf = np.frombuffer(f.read(n_face * np.dtype(fdtype).itemsize), fdtype)

    verts = np.stack([vbuf["x"], vbuf["y"], vbuf["z"]], -1)
    names = [n for n, _ in vprops]
    colors = (
        np.stack([vbuf["red"], vbuf["green"], vbuf["blue"]], -1)
        if "red" in names
        else None
    )
    labels = vbuf["label"] if "label" in names else None
    return verts, fbuf["idx"].copy(), colors, labels
