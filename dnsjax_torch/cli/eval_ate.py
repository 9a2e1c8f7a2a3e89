"""ATE evaluation from a checkpoint of either package:
``python -m dnsjax_torch.cli.eval_ate <config> [--output DIR]``."""

from __future__ import annotations

import argparse
import json
import os


def ate_stats(checkpoint_path: str):
    """Horn-aligned ATE statistics of the frames a ``model.npz`` covers."""
    from dnsjax.eval.ate import evaluate_ate
    from dnsjax_torch.models.checkpoint import load_checkpoint

    ckpt = load_checkpoint(checkpoint_path)
    n = ckpt["meta"]["idx"] + 1
    return evaluate_ate(ckpt["estimate_c2w"][:n], ckpt["gt_c2w"][:n])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None)
    args = parser.parse_args(argv)

    from dnsjax_torch.cli.run import load_run_config

    cfg = load_run_config(args.config)
    out = args.output or os.path.join(cfg.get("out_dir", "output"), cfg.get("scene", "scene"))
    stats = ate_stats(args.checkpoint or os.path.join(out, "model.npz"))
    print(json.dumps({k: v for k, v in stats.items() if not hasattr(v, "shape")}, indent=2))
    return stats


if __name__ == "__main__":
    main()
