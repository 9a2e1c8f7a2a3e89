"""ATE evaluation from a checkpoint of either package:
``python -m dnsjax_torch.cli.eval_ate <config> [--output DIR]``.

As dnsjax.cli.eval_ate: Horn-aligned ATE statistics of the frames the
checkpoint covers, printed as JSON, and the trajectory plot ``<out>/ate.png``
(drawn by ``dnsjax_torch.viz.ate_plot`` with OpenCV)."""

from __future__ import annotations

import argparse
import json
import os


def ate_stats(checkpoint_path: str, plot_path=None):
    """Horn-aligned ATE statistics of the frames a ``model.npz`` covers; with
    ``plot_path``, also the trajectory plot there."""
    from dnsjax_torch.eval.ate import evaluate_ate
    from dnsjax_torch.models.checkpoint import load_checkpoint

    ckpt = load_checkpoint(checkpoint_path)
    n = ckpt["meta"]["idx"] + 1
    est, gt = ckpt["estimate_c2w"][:n], ckpt["gt_c2w"][:n]
    stats = evaluate_ate(est, gt)
    if plot_path is not None:
        from dnsjax_torch.viz.ate_plot import write_ate_plot

        write_ate_plot(plot_path, est, gt, stats["absolute_translational_error.rmse"])
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None)
    args = parser.parse_args(argv)

    from dnsjax_torch.cli.run import load_run_config

    cfg = load_run_config(args.config)
    out = args.output or os.path.join(cfg.get("out_dir", "output"), cfg.get("scene", "scene"))
    stats = ate_stats(args.checkpoint or os.path.join(out, "model.npz"),
                      plot_path=os.path.join(out, "ate.png"))
    print(json.dumps({k: v for k, v in stats.items() if not hasattr(v, "shape")}, indent=2))
    return stats


if __name__ == "__main__":
    main()
