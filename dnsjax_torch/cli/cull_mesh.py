"""Frustum-cull a mesh by a checkpoint's ground-truth trajectory:
``python -m dnsjax_torch.cli.cull_mesh <mesh.ply> <config> --checkpoint
model.npz [--out PATH]``. Same arguments and output as dnsjax.cli.cull_mesh,
whose numpy ``cull`` it shares; the PLY files go through dnsjax's writer,
loaded without jax (``mesh/host.py``)."""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mesh", type=str)
    parser.add_argument("config", type=str)
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="model.npz providing the trajectory")
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)

    from dnsjax.cli.cull_mesh import cull
    from dnsjax_torch.cli.run import load_run_config
    from dnsjax_torch.mesh.host import read_ply, write_ply
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
