"""What the offline CLIs share: config, output dir, dataset and the map of a
``model.npz`` (written by either package) rebuilt on a device."""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def add_common_args(parser) -> None:
    parser.add_argument("config", type=str)
    parser.add_argument("--input", type=str, default=None)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; cuda raises if no card is present")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override a config value, e.g. meshing.resolution=64")


def load_map(args) -> Dict[str, Any]:
    """Config, output dir, dataset, decoder spec, params, encoder params
    and checkpoint dict, as dnsjax's CLIs build them."""
    from dnsjax_torch.data import get_dataset
    from dnsjax_torch.cli.run import load_run_config
    from dnsjax_torch.models.checkpoint import load_checkpoint, params_from_numpy
    from dnsjax_torch.models.decoder import DecoderSpec
    from dnsjax_torch.models.encoder import init_encoder_params
    from dnsjax_torch.slam.driver import load_bound

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_run_config(args.config, 0, args.set, args.input)
    out = args.output or os.path.join(cfg.get("out_dir", "output"), cfg.get("scene", "scene"))
    ckpt = load_checkpoint(args.checkpoint or os.path.join(out, "model.npz"))
    input_folder = cfg.get("input_folder") or os.path.join(
        cfg.get("dataset_dir", ""), cfg.get("scene", ""))
    ds = get_dataset(cfg, input_folder, float(cfg.get("scale", 1)))
    bound = load_bound(cfg)
    spec = DecoderSpec.from_config(cfg, bound, ds.n_class)
    params = params_from_numpy(ckpt, "params", device)
    if any(k.startswith("enc/") for k in ckpt):
        enc = params_from_numpy(ckpt, "enc", device)
    else:
        enc = init_encoder_params(device=device)
    tpu = cfg.get("tpu", {}) or {}
    dtype = torch.bfloat16 if tpu.get("compute_dtype", "bfloat16") == "bfloat16" else torch.float32
    cam = dict(H=ds.H, W=ds.W, fx=ds.fx, fy=ds.fy, cx=ds.cx, cy=ds.cy)
    return dict(cfg=cfg, out=out, ckpt=ckpt, ds=ds, bound=bound, spec=spec, params=params,
                enc=enc, device=device, dtype=dtype, cam=cam)


def keyframes_from_checkpoint(ckpt, ds, device):
    """The keyframe store a checkpoint carries, on ``device``."""
    from dnsjax_torch.slam.keyframes import KeyframeStore

    meta = ckpt["meta"]
    kf = KeyframeStore(int(meta["kf_capacity"]), ds.H, ds.W, int(meta["n_class"]), device)
    for k in range(ckpt["kf/colors"].shape[0]):
        kf.add({"color": ckpt["kf/colors"][k], "depth": ckpt["kf/depths"][k],
                "label": ckpt["kf/labels"][k], "c2w": ckpt["kf/gt_c2w"][k],
                "index": meta["kf_frame_ids"][k]}, ckpt["kf/est_c2w"][k])
    return kf
