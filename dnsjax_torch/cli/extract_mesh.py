"""Offline mesh extraction from a checkpoint of either package:
``python -m dnsjax_torch.cli.extract_mesh <config> [--output DIR]
[--resolution R] [--device cuda|cpu]``. Writes ``mesh_{idx}.ply`` and
``mesh_{idx}_semantic.ply`` beside the checkpoint, as dnsjax.cli.extract_mesh
does."""

from __future__ import annotations

import argparse


def main(argv=None):
    from dnsjax_torch.cli.common import add_common_args, keyframes_from_checkpoint, load_map

    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--resolution", type=int, default=None)
    args = parser.parse_args(argv)
    if args.resolution:
        args.set = list(args.set) + [f"meshing.resolution={args.resolution}"]

    from dnsjax_torch.mesh.mesher import Mesher, class_palette, write_mesh

    m = load_map(args)
    kf = keyframes_from_checkpoint(m["ckpt"], m["ds"], m["device"])
    mesher = Mesher(m["cfg"], m["cam"], m["bound"], m["spec"], m["dtype"])
    idx = m["ckpt"]["meta"]["idx"]
    # the trajectory, for meshing.get_mask_use_all_frames (the driver's hook
    # passes its poses too)
    mesh = mesher.extract(m["params"], m["enc"], kf, class_palette(m["ds"].n_class),
                          all_poses=m["ckpt"]["estimate_c2w"][: idx + 1])
    write_mesh(m["out"], idx, mesh, element=False)
    return mesher, mesh


if __name__ == "__main__":
    main()
