"""SLAM entry point of the PyTorch port:
``python -m dnsjax_torch.cli.run configs/synthetic/textured.yaml [--device cuda]``.

Reads the same YAML stack as ``dnsjax.cli.run`` (scene config over
``configs/slam.yaml``). ``--set key.path=value`` overrides single config
values (YAML scalars), for short runs. ``--resume CKPT`` continues from a
checkpoint of either package; ``--resume-latest`` from the output
directory's ``model.npz``, else its highest ``model_N.npz``.
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import re

import numpy as np


def _parse_value(text: str):
    import yaml

    return yaml.safe_load(text)


def apply_overrides(cfg, overrides):
    """Apply ``a.b.c=value`` strings to the nested config dict in place."""
    for item in overrides or []:
        path, _, text = item.partition("=")
        keys = path.split(".")
        node = cfg
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _parse_value(text)
    return cfg


def load_run_config(config_path: str, seed: int = 0, overrides=None, input_dir=None):
    """The merged config dict exactly as ``dnsjax.cli.run`` builds it."""
    from dnsjax_torch.config import load_config

    default = os.path.join(os.path.dirname(config_path), "..", "slam.yaml")
    if not os.path.exists(default):
        default = "configs/slam.yaml"
    cfg = load_config(config_path, default if os.path.exists(default) else None)
    cfg["seed"] = seed
    if input_dir:
        cfg["input_folder"] = input_dir
    return apply_overrides(cfg, overrides)


def latest_checkpoint(out: str):
    """``model.npz`` in ``out`` if present, else the highest-numbered
    ``model_N.npz`` (by the frame in its name, then mtime); None if none."""
    final = os.path.join(out, "model.npz")
    if os.path.exists(final):
        return final

    def frame_no(p):
        m = re.search(r"model_(\d+)\.npz$", p)
        return (int(m.group(1)) if m else -1, os.path.getmtime(p))

    cands = sorted(glob.glob(os.path.join(out, "model*.npz")), key=frame_no)
    return cands[-1] if cands else None


def main(argv=None):
    parser = argparse.ArgumentParser(description="dnsjax_torch SLAM")
    parser.add_argument("config", type=str, help="scene config yaml")
    parser.add_argument("--input", type=str, default=None, help="dataset dir override")
    parser.add_argument("--output", type=str, default=None, help="output dir override")
    parser.add_argument("--end-frame", type=int, default=None,
                        help="stop after this many frames")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; cuda raises if no card is present")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override a config value, e.g. mapping.n_iters=4")
    parser.add_argument("--resume", type=str, default=None, metavar="CKPT",
                        help="checkpoint (.npz) to resume from")
    parser.add_argument("--resume-latest", action="store_true",
                        help="resume from the newest checkpoint in the output dir "
                             "(model.npz if present, else the highest model_N.npz)")
    args = parser.parse_args(argv)

    random.seed(args.seed)
    np.random.seed(args.seed)
    from dnsjax_torch.slam.driver import DNSSLAM

    cfg = load_run_config(args.config, args.seed, args.set, args.input)
    out = args.output or os.path.join(cfg.get("out_dir", "output"), cfg.get("scene", "scene"))
    slam = DNSSLAM(cfg, output_dir=out, device=args.device)
    start = 0
    if args.resume or args.resume_latest:
        ckpt = args.resume
        if args.resume_latest:
            ckpt = latest_checkpoint(out)
            if ckpt is None:
                parser.error(f"--resume-latest: no model*.npz found in {out}")
        start = slam.resume(ckpt)
        print(f"resumed from {ckpt} at frame {start}", flush=True)
    slam.run(end_frame=args.end_frame, start_frame=start)
    return slam


if __name__ == "__main__":
    main()
