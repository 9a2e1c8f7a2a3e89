"""Strict against asynchronous keysteps, in alternating pairs:
``python -m dnsjax_torch.eval.async_pairs [config] --pairs 4 --frames 21``.

Runs the SLAM loop of ``config`` (default the textured scene) under the
strict schedule with ``tpu.async_map`` off and on, one run after the other
in this process, in the order strict, async, async, strict, ... so that a
drift of the host's speed falls on both sides. Each run's loop wall is the
time from the bootstrap's ``init_map`` event to the ``map`` event of its last
frame (the finish of its keystep), read from its ``metrics.jsonl``, as
``chip_smoke.py``'s ``slam_async_vs_strict`` line reads it. Prints one line
per run and a summary: each pair's strict over async ratio, their mean,
spread and range. Writes ``<out-dir>/async_pairs.json``. ``--set`` passes
config overrides to both sides; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import numpy as np

CONFIG = os.path.join("configs", "synthetic", "textured.yaml")


def loop_wall(out: str, frame: int) -> float:
    """Seconds from the bootstrap's end to the ``map`` event of ``frame``."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    t0 = next(e["t"] for e in events if e["event"] == "init_map")
    return next(e["t"] for e in events if e["event"] == "map" and e["frame"] == frame) - t0


def one_run(config: str, out: str, frames: int, asynchronous: bool, sets, device: str):
    """One run of ``frames`` frames; its loop wall and the driver's means."""
    from dnsjax_torch.cli import run as cli_run

    if os.path.isdir(out):
        shutil.rmtree(out)
    argv = [config, "--device", device, "--output", out, "--end-frame", str(frames),
            "--set", f"tpu.async_map={'true' if asynchronous else 'false'}",
            "--set", "sync_method=strict"]
    for item in sets:
        argv += ["--set", item]
    t0 = time.perf_counter()
    slam = cli_run.main(argv)
    wall = time.perf_counter() - t0
    return dict(async_map=slam.async_map, loop_s=loop_wall(out, frames - 1), wall_s=wall,
                track_avg_s=float(np.mean(slam.track_times)),
                keystep_avg_s=float(np.mean(slam.map_times[1:])),
                keysteps=len(slam.map_times) - 1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("config", nargs="?", default=CONFIG)
    parser.add_argument("--pairs", type=int, default=4)
    parser.add_argument("--frames", type=int, default=21,
                        help="frames a run; the last one's keystep ends the loop wall")
    parser.add_argument("--out-dir", default=os.path.join("output", "async_pairs"))
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = parser.parse_args(argv)

    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
    runs, pairs = [], []
    for p in range(args.pairs):
        order = (False, True) if p % 2 == 0 else (True, False)
        pair = {}
        for asynchronous in order:
            name = "async" if asynchronous else "strict"
            row = one_run(args.config, os.path.join(args.out_dir, name), args.frames,
                          asynchronous, args.set, args.device)
            row.update(pair=p)
            print("async_pairs_run " + json.dumps(row), flush=True)
            runs.append(row)
            pair[name] = row["loop_s"]
        pairs.append(pair["strict"] / pair["async"])
    ratios = np.asarray(pairs)
    summary = dict(card=card, frames=args.frames, pairs=args.pairs, sets=args.set,
                   strict_over_async=ratios.tolist(), mean=float(ratios.mean()),
                   std=float(ratios.std(ddof=1)) if len(ratios) > 1 else None,
                   min=float(ratios.min()), max=float(ratios.max()), runs=runs)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "async_pairs.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("async_pairs " + json.dumps({k: v for k, v in summary.items() if k != "runs"}),
          flush=True)
    return summary


if __name__ == "__main__":
    main()
