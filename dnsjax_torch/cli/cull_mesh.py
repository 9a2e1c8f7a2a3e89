"""Frustum-cull a mesh by a checkpoint's ground-truth trajectory:
``python -m dnsjax_torch.cli.cull_mesh <mesh.ply> <config> --checkpoint
model.npz [--out PATH]``. Same arguments and output as dnsjax.cli.cull_mesh;
``cull`` is the port's own copy of its numpy body.

Counterpart of the reference cull_mesh.py:9-79 (used to prepare GT meshes
for eval_3d): drop faces whose vertices fall outside every camera frustum.
"""

from __future__ import annotations

import argparse

import numpy as np


def cull(verts, faces, poses, H, W, fx, fy, cx, cy):
    w2c = np.linalg.inv(poses)  # (N,4,4)
    pts = np.concatenate([verts, np.ones_like(verts[:, :1])], -1)  # (V,4)
    seen = np.zeros(verts.shape[0], bool)
    for i in range(w2c.shape[0]):
        pc = (w2c[i] @ pts.T).T[:, :3]
        depth = -pc[:, 2]
        u = fx * pc[:, 0] / np.maximum(depth, 1e-6) + cx
        v = -fy * pc[:, 1] / np.maximum(depth, 1e-6) + cy
        seen |= (depth > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    keep = seen[faces].all(1)
    faces = faces[keep]
    used = np.unique(faces)
    remap = np.full(verts.shape[0], -1, np.int64)
    remap[used] = np.arange(used.size)
    return verts[used], remap[faces].astype(np.int32), used


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mesh", type=str)
    parser.add_argument("config", type=str)
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="model.npz providing the trajectory")
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)

    from dnsjax_torch.cli.run import load_run_config
    from dnsjax_torch.mesh.export import read_ply, write_ply
    from dnsjax_torch.models.checkpoint import load_checkpoint

    cam = load_run_config(args.config)["cam"]
    ckpt = load_checkpoint(args.checkpoint)
    poses = ckpt["gt_c2w"][: ckpt["meta"]["idx"] + 1]
    verts, faces, colors, labels = read_ply(args.mesh)
    v2, f2, used = cull(
        verts, faces, poses[np.isfinite(poses).all((1, 2))], cam["H"], cam["W"],
        cam.get("fx", cam["W"] / 2.0), cam.get("fy", cam["W"] / 2.0),
        cam.get("cx", (cam["W"] - 1) / 2.0), cam.get("cy", (cam["H"] - 1) / 2.0),
    )
    out = args.out or args.mesh.replace(".ply", "_culled.ply")
    write_ply(out, v2, f2, colors=None if colors is None else colors[used] / 255.0,
              labels=None if labels is None else labels[used])
    print(f"culled {verts.shape[0]} -> {v2.shape[0]} verts, saved {out}")
    return out


if __name__ == "__main__":
    main()
