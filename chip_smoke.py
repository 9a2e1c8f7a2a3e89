"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--end-frame N]

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: the card's name and power limit (nvidia-smi) and the nvcc
     build of the kernels from ``dnsjax_torch/csrc``;
  2. kernels: each CUDA kernel against its plain PyTorch twin on the same
     inputs, at the shapes of the textured scene (4 levels, 2^16 rows, 8
     features, tet; the 1992-ray mapping batch and the 500-ray tracking
     batch, 47 samples each) and the synthetic scene (8 levels, 2^13 rows, 2
     features, tet and trilinear): forward output and residuals, table
     gradient, position gradient and forward-mode tangent; max errors and
     median times (CUDA events) of kernel and twin;
  3. SLAM: ``dnsjax_torch.cli.run configs/synthetic/textured.yaml`` on the
     card (all 40 frames unless --end-frame), then ATE RMSE of the written
     model.npz, last keystep PSNR and the kernels' launch counts in that run;
     then a torch.profiler breakdown of one mapping call and one tracked frame;
  4. no JAX in the process.
Prints a JSON line of per-kernel results, then the device line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _median_ms(fn, n: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_kernels(results):
    """Phase 2. Returns per-kernel dicts {max_abs_err, ms, plain_ms}."""
    import torch

    from dnsjax_torch.ops import gather, hashgrid, scatter

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [
        # (name, spec kwargs, N, timed)
        ("textured-map", dict(n_levels=4, n_features=8, log2_hashmap_size=16,
                              base_resolution=16, desired_resolution=224, interp="tet",
                              grad_corners=1, gather_bf16=True, scatter="pallas_sr"),
         1992 * 47, True),
        ("textured-track", dict(n_levels=4, n_features=8, log2_hashmap_size=16,
                                base_resolution=16, desired_resolution=224, interp="tet",
                                grad_corners=1, gather_bf16=True, scatter="pallas_sr"),
         500 * 47, False),
        ("synthetic-tet", dict(n_levels=8, n_features=2, log2_hashmap_size=13,
                               base_resolution=8, desired_resolution=112, interp="tet"),
         999 * 32, False),
        ("synthetic-trilinear", dict(n_levels=8, n_features=2, log2_hashmap_size=13,
                                     base_resolution=8, desired_resolution=112),
         999 * 32, False),
    ]
    fwd = results["hash_encode_fwd"]
    sca = results["scatter_add"]
    for name, kw, N, timed in cases:
        spec = hashgrid.HashGridSpec(**kw)
        L, T, F = spec.n_levels, spec.table_size, spec.n_features
        table = torch.rand((L, T, F), generator=gen, device=dev) * 2 - 1
        # points inside the unit cube plus a margin outside it (clamped)
        pts = torch.rand((N, 3), generator=gen, device=dev) * 1.1 - 0.05
        got = gather.encode_forward(pts, table, spec, True)
        ref = gather.encode_forward_plain(pts, table, spec, True)
        torch.cuda.synchronize()
        errs = {}
        for label, a, b in zip(("out", "feats", "idx", "w", "aux"), got, ref):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{name} {label}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
            errs[label] = _max_err(a, b)
        # same bf16 rows and the same float32 steps: at most rounding of the
        # <= 8-term float32 sum
        if errs["out"] > 1e-6 or errs["idx"] != 0 or errs["aux"] > 0 or errs["w"] > 1e-6:
            raise AssertionError(f"{name} forward mismatch: {errs}")
        out, feats, idx, w, aux = got
        g = torch.randn(out.shape, generator=gen, device=dev)
        gl = g.reshape(N, L, F)
        d_pts = hashgrid._position_grad(spec, pts, feats, aux, gl)
        d_pts_ref = hashgrid._position_grad(spec, pts, ref[1], ref[4], gl)
        e_pos = _max_err(d_pts, d_pts_ref)
        dfrac = hashgrid._position_dfrac(spec, feats, aux)
        dfrac_ref = hashgrid._position_dfrac(spec, ref[1], ref[4])
        e_jvp = _max_err(dfrac, dfrac_ref)
        # table gradient: kernel scatter vs plain scatter on the same
        # (stochastically rounded) contributions; atomics reorder the sums
        li, lv = hashgrid._table_grad_inputs(spec, idx, w, gl)
        d_tab = scatter.scatter_add(li, lv, T)
        d_tab_ref = scatter.scatter_add_plain(li, lv, T)
        torch.cuda.synchronize()
        e_tab = _max_err(d_tab, d_tab_ref)
        # reordering a float32 sum moves it by at most ~n * eps * sum|v|: each
        # row is held to 1e-5 of its sum of contribution magnitudes
        tab_bound = 1e-7 + 1e-5 * scatter.scatter_add_plain(li, lv.abs(), T)
        tab_ok = bool(((d_tab - d_tab_ref).abs() <= tab_bound).all())
        if e_pos > 1e-4 * max(1.0, float(d_pts_ref.abs().max())) or e_jvp > 1e-6 or not tab_ok:
            raise AssertionError(f"{name} backward mismatch: pos {e_pos} jvp {e_jvp} table {e_tab}")
        line = dict(case=name, N=N, fwd_err=errs["out"], table_grad_err=e_tab,
                    pos_grad_err=e_pos, jvp_err=e_jvp)
        print("kernel check " + json.dumps(line), flush=True)
        fwd["max_abs_err"] = max(fwd["max_abs_err"], errs["out"], errs["w"])
        sca["max_abs_err"] = max(sca["max_abs_err"], e_tab)
        if timed:
            fwd["ms"] = _median_ms(lambda: gather.encode_forward(pts, table, spec, True))
            fwd["plain_ms"] = _median_ms(lambda: gather.encode_forward_plain(pts, table, spec, True))
            sca["ms"] = _median_ms(lambda: scatter.scatter_add(li, lv, T))
            sca["plain_ms"] = _median_ms(lambda: scatter.scatter_add_plain(li, lv, T))
            print(f"timing {name}: encode fwd {fwd['ms']:.4f} ms (plain {fwd['plain_ms']:.4f}), "
                  f"scatter {sca['ms']:.4f} ms (plain {sca['plain_ms']:.4f})", flush=True)


def run_slam(end_frame):
    import numpy as np

    from dnsjax_torch.cli import run as cli_run
    from dnsjax_torch.cli.eval_ate import ate_stats
    from dnsjax_torch.ops import gather, scatter

    out = os.path.join(ROOT, "output", "chip_smoke_textured")
    if os.path.exists(os.path.join(out, "metrics.jsonl")):
        os.remove(os.path.join(out, "metrics.jsonl"))
    argv = [os.path.join(ROOT, "configs", "synthetic", "textured.yaml"),
            "--device", "cuda", "--output", out]
    if end_frame:
        argv += ["--end-frame", str(end_frame)]
    gather.LAUNCHES = 0
    scatter.LAUNCHES = 0
    t0 = time.perf_counter()
    slam = cli_run.main(argv)
    wall = time.perf_counter() - t0
    launches = {"hash_encode_fwd": gather.LAUNCHES, "scatter_add": scatter.LAUNCHES}
    ate = float(ate_stats(os.path.join(out, "model.npz"))["absolute_translational_error.rmse"])
    n = min(end_frame, slam.n_img) if end_frame else slam.n_img
    psnr = slam.last_map_aux["psnr"]
    track = float(np.mean(slam.track_times))
    keystep = float(np.mean(slam.map_times[1:])) if len(slam.map_times) > 1 else float("nan")
    summary = dict(frames=n, wall_s=wall, init_map_s=slam.map_times[0], track_avg_s=track,
                   keystep_avg_s=keystep, ate_rmse_m=ate, last_keystep_psnr=psnr,
                   launches=launches)
    print("slam " + json.dumps(summary), flush=True)
    if not all(np.isfinite(v) for v in (ate, psnr, track, keystep)):
        raise AssertionError(f"non-finite SLAM result: {summary}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if not ate < 0.3:
        raise AssertionError(f"ATE RMSE {ate} m >= 0.3 m")
    if not psnr > 20.0:
        raise AssertionError(f"last keystep PSNR {psnr} <= 20 dB")
    return slam, launches


def profile_slam(slam, n_iters: int = 20):
    """torch.profiler over one mapping call of ``n_iters`` iterations and one
    tracked frame of the finished run: wall, summed device time, device busy
    share and the top device kernels by self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    idx = len(slam.dataset) - 1
    cur = slam._frame_to_device(slam.dataset[idx])
    slam.map_once(idx, cur, 2, "global", False)  # warm the window caches
    torch.cuda.synchronize()
    phases = {
        "keystep_call": lambda: slam.map_once(idx, cur, n_iters, "global", False),
        "track_frame": lambda: slam.track_frame(idx, cur),
    }
    for name, fn in phases.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
        dev_ms = sum(dev_us(e) for e in events) / 1e3
        top = sorted(events, key=lambda e: -dev_us(e))[:12]
        print("profile " + json.dumps(dict(
            phase=name, iters=n_iters if name == "keystep_call" else 1, wall_ms=wall_ms,
            device_ms=dev_ms, device_busy_share=dev_ms / wall_ms,
            kernel_launches=sum(e.count for e in events),
            top=[(e.key[:60], round(dev_us(e) / 1e3, 3), e.count) for e in top],
        )), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--end-frame", type=int, default=None)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke run needs a GPU", 2)
    sys.path.insert(0, ROOT)
    try:
        from dnsjax_torch.ops import _cuda
    except ImportError as e:
        _fail(f"the dnsjax_torch package is not beside this script ({e})", 3)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    _cuda.library()
    print(f"kernel build {_cuda.build_seconds:.2f} s", flush=True)
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  nvcc: " + line.strip(), flush=True)

    results = {
        "hash_encode_fwd": dict(name="hash_encode_fwd", route="cuda",
                                source="dnsjax_torch/csrc/hashgrid.cu",
                                replaces="dnsjax/ops/gather.py:49", launches=0,
                                max_abs_err=0.0, ms=None, plain_ms=None),
        "scatter_add": dict(name="scatter_add", route="cuda",
                            source="dnsjax_torch/csrc/scatter.cu",
                            replaces="dnsjax/ops/scatter.py:213", launches=0,
                            max_abs_err=0.0, ms=None, plain_ms=None),
    }
    check_kernels(results)
    slam, launches = run_slam(args.end_frame)
    for k, v in launches.items():
        results[k]["launches"] = v
    profile_slam(slam)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported by the port")
    print("no jax in sys.modules", flush=True)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
