"""3D mesh evaluation: ``python -m dnsjax_torch.cli.eval_3d rec.ply gt.ply
[--samples N] [--thresh M] [--depth-views N]``.

As dnsjax.cli.eval_3d: accuracy / completion / completion ratio over surface
samples of both meshes, and with ``--depth-views`` the depth L1 from that
many random virtual views (native raycaster). Host only: numpy, scipy and
the native library.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("rec_mesh", type=str)
    parser.add_argument("gt_mesh", type=str)
    parser.add_argument("--samples", type=int, default=200_000)
    parser.add_argument("--thresh", type=float, default=0.05)
    parser.add_argument("--depth-views", type=int, default=0,
                        help="also compute depth-L1 from N random virtual "
                        "views (needs the native raycaster)")
    args = parser.parse_args(argv)

    from dnsjax_torch.eval.mesh_metrics import depth_l1_virtual_views, mesh_metrics
    from dnsjax_torch.mesh.export import read_ply

    rv, rf, _, _ = read_ply(args.rec_mesh)
    gv, gf, _, _ = read_ply(args.gt_mesh)
    m = mesh_metrics(rv, rf, gv, gf, n_samples=args.samples, thresh=args.thresh)
    if args.depth_views > 0:
        m.update(depth_l1_virtual_views(rv, rf, gv, gf, n_views=args.depth_views))
    print(json.dumps(m, indent=2))
    return m


if __name__ == "__main__":
    main()
