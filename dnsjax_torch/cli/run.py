"""SLAM entry point of the PyTorch port:
``python -m dnsjax_torch.cli.run configs/synthetic/textured.yaml [--device cuda]``.

Reads the same YAML stack as ``dnsjax.cli.run`` (scene config over
``configs/slam.yaml``). ``--set key.path=value`` overrides single config
values (YAML scalars), for short runs. ``--resume CKPT`` continues from a
checkpoint of either package; ``--resume-latest`` from the output
directory's ``model.npz``, else its highest ``model_N.npz``.

``tpu.data_parallel: N`` (N > 1) runs over several processes, one rank a
device (``slam/driver.py``): on a host with more than one card this
command starts ``min(N, cards)`` ranks itself, rank r on ``cuda:r`` over
NCCL. ``--ranks R`` starts R ranks explicitly (at most N): each on a card
of its own over NCCL when there are R cards, else all on ``--device``
over gloo (several ranks on one card, or on the CPU). Rank 0 alone writes
to ``--output``.

The composed operating point (``tpu.map_device: M`` >= 1 or ``tpu.map_dp:
D`` > 1: the keystep on the ranks ``[M, M + D)``, the tracker on rank 0,
``tpu.mesh_async`` the extraction beside them; under ``tpu.data_parallel``
``map_device`` alone starts no rank of its own) always runs over ranks: this
command starts ``max(M + D, 2)`` of them (``--ranks`` may name that count
or more; a rank past the keystep's idles), on cards of their own over NCCL
when there are that many, else on ``--device`` over gloo. Rank 0 writes the
logs, panels and checkpoints, the keystep's first rank the meshes.
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import re
import sys

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
    parser.add_argument("--ranks", type=int, default=None,
                        help="processes of a tpu.data_parallel run (default: min(N, cards) "
                             "with more than one card, else 1) or of the composed point "
                             "(default max(map_device + map_dp, 2)); see the module docstring")
    args = parser.parse_args(argv)
    ranks = _ranks(args)
    if ranks > 1:
        return _spawn_ranks(args, ranks, argv)

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


def composed_ranks(cfg) -> int:
    """The ranks the composed operating point asks for:
    ``max(map_device + map_dp, 2)`` when ``tpu.map_device`` >= 1 or
    ``tpu.map_dp`` > 1, else 0 (not composed). Under ``tpu.data_parallel``
    a ``map_device`` alone names no rank of its own (the data-parallel ranks
    run the keystep), so that count decides."""
    tpu = cfg.get("tpu") or {}
    first, map_dp = int(tpu.get("map_device", 0)), int(tpu.get("map_dp", 1))
    if (first < 1 or int(tpu.get("data_parallel", 1)) > 1) and map_dp < 2:
        return 0
    return max(first + map_dp, 2)


def _ranks(args) -> int:
    """The ranks this command starts: the composed point's (``--ranks`` may
    name more), else ``--ranks``, else min(data_parallel, cards) on a host
    with more than one card, else 1 (and 1 inside a rank)."""
    import torch
    import torch.distributed as dist

    from dnsjax_torch.slam.driver import check_supported

    if dist.is_initialized():
        return 1
    cfg = load_run_config(args.config, args.seed, args.set, args.input)
    n_dp = int((cfg.get("tpu") or {}).get("data_parallel", 1))
    need = composed_ranks(cfg)
    if need:
        ranks = need if args.ranks is None else args.ranks
        if ranks < need:
            raise SystemExit(f"--ranks {ranks}: the composed point needs {need} ranks "
                             "(tpu.map_device + tpu.map_dp, at least 2)")
        check_supported(cfg, ranks)  # map_dp with data_parallel raises here
        return ranks
    if args.ranks is not None:
        if not 1 <= args.ranks <= max(n_dp, 1):
            raise SystemExit(f"--ranks {args.ranks}: needs 1 <= ranks <= tpu.data_parallel "
                             f"({n_dp})")
        return args.ranks
    if n_dp > 1 and args.device.startswith("cuda") and torch.cuda.is_available():
        cards = torch.cuda.device_count()
        if cards > 1:
            return min(n_dp, cards)
    return 1


def rank_devices(device: str, ranks: int):
    """One card a rank when there are enough, else every rank on
    ``device``."""
    import torch

    if device.startswith("cuda") and torch.cuda.is_available() \
            and torch.cuda.device_count() >= ranks:
        return [f"cuda:{r}" for r in range(ranks)]
    return [device] * ranks


def _spawn_ranks(args, ranks: int, argv):
    from dnsjax_torch.parallel.launch import backend_for, spawn

    devices = rank_devices(args.device, ranks)
    backend = backend_for(devices)
    print(f"starting {ranks} ranks over {backend} on {devices}", flush=True)
    # CPU ranks share the host's cores
    threads = max(1, (os.cpu_count() or 1) // ranks) if devices[0] == "cpu" else 0
    spawn(_rank_run, ranks, backend, devices, args=(list(argv or sys.argv[1:]),),
          threads=threads, pg_timeout=1800.0, join_timeout=None)
    return None


def _rank_run(rank, device, argv):
    """One rank of a data-parallel or composed run: this command on
    ``device``."""
    main(list(argv) + ["--device", str(device)])


if __name__ == "__main__":
    main()
