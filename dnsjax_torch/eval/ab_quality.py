"""The A/B quality gate of ``scripts/ab_quality.py``, run on the port:
``python -m dnsjax_torch.eval.ab_quality [--variants a,b] [--seeds 0,1,2]
[--frames 40] [--eval-every 7] [--small] [--protocol kf|self] [--skip-done]
[--report-only] [--device cuda|cpu] [--out-dir DIR]``.

Full SLAM (tracking, mapping, BA) of the port on the textured synthetic
scene (``configs/synthetic/textured.yaml``, 680x1200, 30 classes; 170x300
with ``--small``) once per (variant, seed), each in its own subprocess, then
ATE RMSE of the run and, over frames 4, 4 + e, ... < frames, render PSNR and
depth L1 (cm) over the pixels with valid depth and semantic mIoU. The
``kf`` protocol (rows tagged ``@kf``) conditions each render on the three
keyframe views nearest by estimated camera position (``cli/eval_2d.py``'s
``FrameRenderer``); ``self`` is the legacy self-conditioned one.

The port cannot import the script (it imports dnsjax), so this module keeps
its own copies of ``VARIANTS``, ``BASE_SCHEDULE`` and ``build_variant_cfg``,
held equal to the script's by ``tests/test_torch_ab_quality.py``. The report
keeps the script's per-run table, its seed spreads and its gate (each
seed-mean within 5 % of the port's own ``parity`` mean), and adds whether
each seed-mean lies inside the JAX package's 3-seed range (``JAX_RANGES``).
Results go to ``<out-dir>/ab_quality_torch.json`` and
``<out-dir>/AB_QUALITY_TORCH.md`` (default ``output/ab_quality_torch``), the
runs to ``<tmp>/ab_torch_<key>``; the repository root's ``AB_QUALITY.md``
and ``ab_quality.json`` are never written.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCENE = os.path.join(ROOT, "configs", "synthetic", "textured.yaml")
DEFAULT_CFG = os.path.join(ROOT, "configs", "slam.yaml")
METRICS = ("ate_rmse_m", "psnr_db", "depth_l1_cm", "miou")

_TPU_GRID = dict(n_levels=4, level_dim=8, grad_corners=1, gather_bf16=True,
                 interp="trilinear", grad_levels=0, scatter="xla")
_ADAM_TRACK = dict(method="adam", patience=10)

# name -> {config section -> overrides}; sections: grid (model.grid), tpu,
# pos (model.pos), training, tracking, mapping. Every variant pins
# pos.kernel, training.smooth_every and tracking.method, so a change of the
# configs/slam.yaml defaults cannot change what it measures.
VARIANTS = {
    "parity": dict(
        grid=dict(n_levels=16, level_dim=2, grad_corners=8, gather_bf16=False,
                  interp="trilinear", grad_levels=0, scatter="xla"),
        tpu=dict(compute_dtype="float32", feature_taps=4),
        pos=dict(kernel="gaussian"),
        training=dict(smooth_every=1),
        tracking=dict(method="adam", patience=0),
        mapping=dict(max_iters_per_dispatch=25),
    ),
    "r1-tpu": dict(
        tracking=dict(_ADAM_TRACK), grid=dict(_TPU_GRID), tpu=dict(feature_taps=1),
        pos=dict(kernel="gaussian"), training=dict(smooth_every=1)),
    "tet4x8": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID, interp="tet"), tpu=dict(feature_taps=1),
        pos=dict(kernel="gaussian"), training=dict(smooth_every=1),
    ),
    "tet4x8-gl1": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID, interp="tet", grad_levels=1),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="gaussian"), training=dict(smooth_every=1),
    ),
    "tet2x16": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID, n_levels=2, level_dim=16, interp="tet"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="gaussian"), training=dict(smooth_every=1),
    ),
    "tet2x16-gl1": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID, n_levels=2, level_dim=16, interp="tet",
                  grad_levels=1),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="gaussian"), training=dict(smooth_every=1),
    ),
    "r1-tpu-randenc": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID), tpu=dict(feature_taps=1, encoder_init="random"),
        pos=dict(kernel="gaussian"), training=dict(smooth_every=1),
    ),
    "tet4x8-quartic-sm4": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID, interp="tet"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
    ),
    "tet4x8-quartic": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID, interp="tet"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=1),
    ),
    "tet4x8-sm4": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID, interp="tet"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="gaussian"),
        training=dict(smooth_every=4),
    ),
    "tet4x8-quartic-sm4-scpallas": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
    ),
    "tet4x8-quartic-sm4-scpallas-split": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_split"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
    ),
    "tet4x8-quartic-sm4-scpallas-sr": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
    ),
    "tet2x16-quartic-sm4": dict(
        tracking=dict(_ADAM_TRACK),
        grid=dict(_TPU_GRID, n_levels=2, level_dim=16, interp="tet"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
    ),
    "lm-track": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0),
    ),
    "lm-track-pat": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
        tracking=dict(method="lm", lm_iters=10, lm_patience=3),
    ),
    "m50": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0),
        mapping=dict(n_iters=50),
    ),
    "map10": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0),
        mapping=dict(optimize_every_n_frames=10),
    ),
    "m50-map10": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0),
        mapping=dict(n_iters=50, optimize_every_n_frames=10),
    ),
    "ns16": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4, n_samples_ray=16),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0),
    ),
    "ns16-m50-map10": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4, n_samples_ray=16),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0),
        mapping=dict(n_iters=50, optimize_every_n_frames=10),
    ),
    "ns16-m50-map10-pat": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4, n_samples_ray=16),
        tracking=dict(method="lm", lm_iters=10, lm_patience=3),
        mapping=dict(n_iters=50, optimize_every_n_frames=10),
    ),
    # the adopted production bundle: 16 + 15 samples a ray, 50-iteration
    # keysteps every 10 frames, 8 LM iterations
    "ns16-m50-map10-lm8": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4, n_samples_ray=16),
        tracking=dict(method="lm", lm_iters=8, lm_patience=0),
        mapping=dict(n_iters=50, optimize_every_n_frames=10),
    ),
    "ns16-m50-map10-lm8-lam2": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4, n_samples_ray=16),
        tracking=dict(method="lm", lm_iters=8, lm_patience=0,
                      lm_lambda0=1e-2),
        mapping=dict(n_iters=50, optimize_every_n_frames=10),
    ),
    "ns16-m50-map10-lm8-lam4": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4, n_samples_ray=16),
        tracking=dict(method="lm", lm_iters=8, lm_patience=0,
                      lm_lambda0=1e-4),
        mapping=dict(n_iters=50, optimize_every_n_frames=10),
    ),
    "ns16-m50-map10-lm8-ud": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4, n_samples_ray=16),
        tracking=dict(method="lm", lm_iters=8, lm_patience=0,
                      lm_up=2.0, lm_down=0.75),
        mapping=dict(n_iters=50, optimize_every_n_frames=10),
    ),
    "ns16-m25-map10-lm8": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4, n_samples_ray=16),
        tracking=dict(method="lm", lm_iters=8, lm_patience=0),
        mapping=dict(n_iters=25, optimize_every_n_frames=10,
                     max_iters_per_dispatch=25),
    ),
    "ns16-m25-map10": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4, n_samples_ray=16),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0),
        mapping=dict(n_iters=25, optimize_every_n_frames=10,
                     max_iters_per_dispatch=25),
    ),
    "px4k-m50": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0),
        mapping=dict(n_pixels=4000, n_iters=50, n_iters_first=250),
    ),
    "px8k-m25": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0),
        mapping=dict(n_pixels=8000, n_iters=25, n_iters_first=125,
                     max_iters_per_dispatch=25),
    ),
    "ns16-px4k-m50": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4, n_samples_ray=16),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0),
        mapping=dict(n_pixels=4000, n_iters=50, n_iters_first=250),
    ),
    "lm-px2k": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0,
                      n_pixels=2000),
    ),
    "lm-px1k": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0,
                      n_pixels=1000),
    ),
    "ns16-px1k": dict(
        grid=dict(_TPU_GRID, interp="tet", scatter="pallas_sr"),
        tpu=dict(feature_taps=1),
        pos=dict(kernel="quartic"),
        training=dict(smooth_every=4, n_samples_ray=16),
        tracking=dict(method="lm", lm_iters=10, lm_patience=0,
                      n_pixels=1000),
    ),
}

# The reference schedule (configs/replica/replica.yaml's shape), frozen here
# whatever configs/slam.yaml says; a variant's overrides apply on top.
BASE_SCHEDULE = dict(
    training=dict(n_samples_ray=32),
    mapping=dict(n_iters=100, n_iters_first=500,
                 optimize_every_n_frames=5, n_pixels=2000),
    tracking=dict(n_iters=50, n_pixels=500),
)

# The JAX package's 3-seed ranges (min, max) of the variants the port's gate
# runs, copied from AB_QUALITY.md's seed-spread table: parity@kf is
# AB_QUALITY.md:82, lm-track@kf :83, ns16-m50-map10@kf :85,
# ns16-m50-map10-lm8@kf :90. Quality numbers of the JAX package's runs, not
# times.
JAX_RANGES = {
    "parity@kf": dict(ate_rmse_m=(0.0144, 0.0191), psnr_db=(31.3360, 34.1502),
                      depth_l1_cm=(1.0610, 1.5597), miou=(0.9666, 0.9997)),
    "lm-track@kf": dict(ate_rmse_m=(0.0156, 0.0354), psnr_db=(31.0003, 32.8793),
                        depth_l1_cm=(1.1189, 1.3415), miou=(0.9650, 0.9999)),
    "ns16-m50-map10@kf": dict(ate_rmse_m=(0.0101, 0.0181), psnr_db=(30.6275, 31.7506),
                              depth_l1_cm=(0.9560, 1.1418), miou=(0.9574, 0.9647)),
    "ns16-m50-map10-lm8@kf": dict(ate_rmse_m=(0.0113, 0.0165), psnr_db=(31.3675, 31.5325),
                                  depth_l1_cm=(0.9666, 1.1609), miou=(0.9575, 0.9653)),
}


def build_variant_cfg(name, overrides, frames, small, seed=0):
    """The full SLAM config of one A/B variant run: the scene over
    configs/slam.yaml, the frozen base schedule, the variant's overrides,
    ``seed`` (the scene's own ``synthetic.seed`` stays as the file sets it)."""
    from dnsjax_torch.config import load_config

    cfg = load_config(SCENE, DEFAULT_CFG)
    cfg["synthetic"]["n_frames"] = frames
    for sec, vals in BASE_SCHEDULE.items():
        cfg[sec].update(vals)
    cfg["model"]["grid"].update(overrides.get("grid", {}))
    cfg["model"]["pos"].update(overrides.get("pos", {}))
    cfg["tpu"].update(overrides.get("tpu", {}))
    cfg["training"].update(overrides.get("training", {}))
    cfg["mapping"].update(overrides.get("mapping", {}))
    cfg["tracking"].update(overrides.get("tracking", {}))
    cfg["seed"] = seed
    cfg["verbose"] = False
    if small:
        cfg["cam"].update(H=170, W=300, fx=150.0, fy=150.0, cx=149.5, cy=84.5)
        # a variant whose axis is the pixel count keeps its own
        if "n_pixels" not in overrides.get("mapping", {}):
            cfg["mapping"]["n_pixels"] = 1000
        if "n_pixels" not in overrides.get("tracking", {}):
            cfg["tracking"]["n_pixels"] = 300
        cfg["tracking"]["ignore_edge"] = 5
    return cfg


def score_run(slam, est, gt, frames, eval_every, protocol="kf"):
    """The gate's metrics of a finished run (a port ``DNSSLAM``, its
    estimated and GT poses): ATE RMSE (m), and over frames 4, 4 +
    eval_every, ... < frames the mean PSNR (dB) and depth L1 (cm) over the
    pixels with valid depth and the mean semantic mIoU, each frame rendered
    by ``FrameRenderer`` (keyframe views under ``kf``, the frame itself under
    ``self``) with the encoder at its default bf16, as the script scores."""
    from dnsjax_torch.cli.eval_2d import FrameRenderer
    from dnsjax_torch.eval.ate import evaluate_ate
    from dnsjax_torch.eval.render_metrics import psnr
    from dnsjax_torch.eval.semantic import semantic_metrics
    from dnsjax_torch.models.encoder import encode_images
    from dnsjax_torch.render.full import make_full_renderer

    ate = evaluate_ate(est, gt)["absolute_translational_error.rmse"]
    ds = slam.dataset
    renderer = make_full_renderer(
        slam.spec, dict(H=ds.H, W=ds.W, fx=ds.fx, fy=ds.fy, cx=ds.cx, cy=ds.cy),
        slam.map_cfg.n_samples, slam.map_cfg.n_surface, compute_dtype=slam.compute_dtype)
    kf = slam.keyframes
    use_kf = protocol == "kf" and kf.count > 0
    render = FrameRenderer(
        renderer, slam.params, lambda imgs: encode_images(slam.enc_params, imgs),
        slam.bound, slam.device, slam.map_cfg.n_surface,
        kf_c2w=kf.est_c2w[:kf.count].cpu().numpy() if use_kf else None,
        kf_colors=kf.colors if use_kf else None)
    psnrs, dl1s, mious = [], [], []
    for idx in range(4, frames, eval_every):
        f = ds[idx]
        color, depth, logits = render(idx, f, est[idx])
        color, depth = color.cpu().numpy(), depth.cpu().numpy()
        pred_label = logits.argmax(-1).cpu().numpy()
        valid = f["depth"] > 0
        psnrs.append(psnr(f["color"], color, valid))
        dl1s.append(float(np.abs(depth - f["depth"])[valid].mean()))
        mious.append(semantic_metrics(f["label"], pred_label, ds.n_class, valid)["miou"])
    return {
        "ate_rmse_m": float(ate),
        "psnr_db": float(np.mean(psnrs)),
        "depth_l1_cm": float(np.mean(dl1s) * 100),
        "miou": float(np.mean(mious)),
    }


def run_variant(name, overrides, frames, small, eval_every, seed=0, protocol="kf",
                device="cuda", out=None, sets=()):
    """One full run of a variant on ``device`` into ``out`` (default
    ``<tmp>/ab_torch_<name>``, emptied first), scored by ``score_run``;
    returns the script's dict (``wall_s``: the run, host clock, 0.1 s).
    ``sets``: ``key.path=value`` overrides on top, for short runs."""
    from dnsjax_torch.cli.run import apply_overrides
    from dnsjax_torch.slam.driver import DNSSLAM

    cfg = apply_overrides(build_variant_cfg(name, overrides, frames, small, seed), sets)
    out = out or os.path.join(tempfile.gettempdir(), f"ab_torch_{name}")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    slam = DNSSLAM(cfg, output_dir=out, device=device)
    est, gt = slam.run()
    wall = time.perf_counter() - t0
    result = score_run(slam, est, gt, frames, eval_every, protocol)
    result["wall_s"] = round(wall, 1)
    return result


def run_key(name, seed, small, protocol):
    """The script's result key: ``name[@s<seed>][@small][@kf]``."""
    key = name if seed == 0 else f"{name}@s{seed}"
    if small:
        key += "@small"
    if protocol == "kf":
        key += "@kf"
    return key


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _paths(out_dir):
    return (os.path.join(out_dir, "ab_quality_torch.json"),
            os.path.join(out_dir, "AB_QUALITY_TORCH.md"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="170x300 smoke shape instead of 680x1200")
    ap.add_argument("--variants", type=str, default=",".join(VARIANTS))
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--eval-every", type=int, default=7)
    ap.add_argument("--one", type=str, default=None,
                    help="(internal) run a single variant, print JSON")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=str, default="0",
                    help="comma list; seed s>0 results stored as name@s<s>")
    ap.add_argument("--report-only", action="store_true",
                    help="rewrite the report from the json without running anything")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip keys already completed in the json")
    ap.add_argument("--protocol", choices=["kf", "self"], default="kf",
                    help="reference views of the eval renders: kf = 3 nearest "
                         "keyframe views (rows tagged @kf), self = the frame itself")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", type=str, default=os.path.join("output", "ab_quality_torch"),
                    help="where the json and the report go")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config value of every run, for short runs")
    args = ap.parse_args(argv)
    json_path, _ = _paths(args.out_dir)

    if args.one:
        r = run_variant(args.one, VARIANTS[args.one], args.frames, args.small, args.eval_every,
                        seed=args.seed, protocol=args.protocol, device=args.device,
                        out=os.path.join(tempfile.gettempdir(), "ab_torch_" + run_key(
                            args.one, args.seed, args.small, args.protocol)),
                        sets=args.set)
        print("ABRESULT " + json.dumps(r), flush=True)
        return r

    results = {}
    if os.path.exists(json_path):
        with open(json_path) as f:
            results = json.load(f)
    if args.report_only:
        return write_report(results, args.out_dir)

    os.makedirs(args.out_dir, exist_ok=True)
    card = card_line() if args.device.startswith("cuda") else "cpu"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    seeds = [int(s) for s in args.seeds.split(",")]
    for name in args.variants.split(","):
        for seed in seeds:
            key = run_key(name, seed, args.small, args.protocol)
            if args.skip_done and results.get(key, {}).get("wall_s", -1) > 0:
                print(f"== {key} == already done, skipping", flush=True)
                continue
            print(f"== {key} ==", flush=True)
            cmd = [sys.executable, "-m", "dnsjax_torch.eval.ab_quality", "--one", name,
                   "--frames", str(args.frames), "--eval-every", str(args.eval_every),
                   "--seed", str(seed), "--protocol", args.protocol, "--device", args.device]
            cmd += ["--small"] if args.small else []
            for item in args.set:
                cmd += ["--set", item]
            p = subprocess.run(cmd, capture_output=True, text=True, env=env)
            line = next((l for l in p.stdout.splitlines() if l.startswith("ABRESULT ")), None)
            if line:
                results[key] = dict(json.loads(line[len("ABRESULT "):]), card=card)
            else:
                tail = ((p.stderr or "").strip() or "no output").splitlines()[-1][:300]
                print(f"  failed (rc={p.returncode}): {tail}", flush=True)
                results[key] = dict({m: float("nan") for m in METRICS}, wall_s=-1, card=card)
            print(json.dumps(results[key]), flush=True)
            with open(json_path, "w") as f:  # after each run: a cut sweep keeps its rows
                json.dump(results, f, indent=1)
    return write_report(results, args.out_dir)


def _gate(r, ref) -> bool:
    """The script's gate: every metric within 5 % of the parity reference."""
    return all([
        r["psnr_db"] >= ref["psnr_db"] * 0.95,
        r["miou"] >= ref["miou"] * 0.95,
        r["ate_rmse_m"] <= ref["ate_rmse_m"] * 1.05 + 1e-4,
        r["depth_l1_cm"] <= ref["depth_l1_cm"] * 1.05 + 1e-3,
    ])


def seed_groups(results):
    """{key without its seed tag: [rows]} (``@small`` stays part of it)."""
    groups = {}
    for key, r in results.items():
        groups.setdefault(re.sub(r"@s\d+(?=@|$)", "", key), []).append(r)
    return groups


def in_jax_range(base, means):
    """{metric: seed-mean inside the JAX package's 3-seed range} for a
    group that has one, else None."""
    rng = JAX_RANGES.get(base)
    if rng is None:
        return None
    return {m: bool(rng[m][0] <= means[m] <= rng[m][1]) for m in METRICS}


def write_report(results, out_dir):
    """Write ``AB_QUALITY_TORCH.md`` into ``out_dir`` (never the repository
    root's report); returns the seed-mean rows."""
    lines = [
        "# A/B quality gate on the port (dnsjax_torch)",
        "",
        "Scene: configs/synthetic/textured.yaml (680x1200, 30 classes, full "
        "tracking+mapping+BA), run by `python -m dnsjax_torch.eval.ab_quality`.",
        "Rows tagged `@small` ran the 170x300 smoke shape; rows tagged `@kf` use",
        "the leak-free protocol (renders conditioned on the 3 nearest keyframe",
        "views) and gate against `parity@kf`, untagged rows against `parity`.",
        "Gate: every metric within 5% of the port's own parity run; higher is",
        "better for psnr/miou, lower for ate/depth_l1. `in JAX range`: whether",
        "each seed-mean lies inside the JAX package's 3-seed range",
        "(AB_QUALITY.md:82 and :90).",
        "",
        "| run | ATE RMSE (m) | PSNR (dB) | depth L1 (cm) | mIoU | wall (s) | pass | card |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for name, r in results.items():
        ref = results.get("parity@kf" if name.endswith("@kf") else "parity")
        if ref is None or name in ("parity", "parity@kf") or "@small" in name:
            ok = "—"
        else:
            ok = "yes" if _gate(r, ref) else "NO"
        lines.append(
            f"| {name} | {r['ate_rmse_m']:.4f} | {r['psnr_db']:.2f} | "
            f"{r['depth_l1_cm']:.2f} | {r['miou']:.3f} | {r['wall_s']} | {ok} | "
            f"{r.get('card', '')} |")

    groups = seed_groups(results)

    def group_mean(base, k):
        vs = [r[k] for r in groups.get(base, ()) if not math.isnan(r[k])]
        return float(np.mean(vs)) if vs else float("nan")

    rows = []
    multi = {b: rs for b, rs in groups.items() if len(rs) > 1}
    if multi:
        lines += [
            "",
            "## Multi-seed spreads (mean, min..max over seeds)",
            "",
            "| variant | n | ATE RMSE (m) | PSNR (dB) | depth L1 (cm) | mIoU | mean gate "
            "| in JAX range (ate, psnr, depth, miou) |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for base, rs in multi.items():
            def agg(k):
                vs = [r[k] for r in rs if not math.isnan(r[k])]
                if not vs:
                    return "nan"
                return f"{np.mean(vs):.4f} ({min(vs):.4f}..{max(vs):.4f})"
            anchor = "parity@kf" if base.endswith("@kf") else "parity"
            means = {m: group_mean(base, m) for m in METRICS}
            if base in (anchor, "parity", "parity@kf") or "@small" in base:
                mg = "—"
            else:
                mg = "yes" if _gate(means, {m: group_mean(anchor, m) for m in METRICS}) \
                    else "NO"
            inside = in_jax_range(base, means)
            jr = "—" if inside is None else ", ".join(
                "yes" if inside[m] else "NO" for m in METRICS)
            rows.append(dict(variant=base, n=len(rs), means=means, gate=mg, in_jax_range=inside))
            lines.append(
                f"| {base} | {len(rs)} | {agg('ate_rmse_m')} | {agg('psnr_db')} "
                f"| {agg('depth_l1_cm')} | {agg('miou')} | {mg} | {jr} |")

    os.makedirs(out_dir, exist_ok=True)
    with open(_paths(out_dir)[1], "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    return rows


if __name__ == "__main__":
    main()
