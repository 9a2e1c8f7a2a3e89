"""Fault 7 at the small shape: does the depth L1 rise with 16 samples a ray
under GT poses in dnsjax (on the CPU) as in the port (on ``--device``)?

    python tools/fault7_small.py [--seeds 0,1,2] [--frames 8] [--jobs 2]
                                 [--packages dnsjax,port] [--device cuda]
                                 [--out output/fault7_small.json]

Runs ``scripts/ab_quality.py:run_variant`` (dnsjax, ``JAX_PLATFORMS=cpu``)
and ``dnsjax_torch/eval/ab_quality.py:run_variant`` (the port, on
``--device``: the card by default, ``cpu`` for a run without one)
for the variants ``lm-track`` and ``ns16`` at ``--small`` (170x300) with
``use_gt_camera: true``, one subprocess per (package, variant, seed), each
writing its run under ``output/fault7_small/``, and
scores frames 4..frames-1 (``eval_every`` 1) on the ``@kf`` protocol. dnsjax's
``build_variant_cfg`` passes only the model and schedule sections of a
variant's overrides, so its subprocess wraps that function to set the
top-level ``use_gt_camera`` as the port's ``sets`` does. Prints one line a
run and the depth-L1 seed-means (min..max) by package and variant; writes
every result to ``--out`` as each run ends, and skips the runs already
there (so a sweep may be split over calls).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("lm-track", "ns16")
RUNS = os.path.join(ROOT, "output", "fault7_small")


def _one(pkg: str, name: str, seed: int, frames: int, out: str, device: str) -> dict:
    """One run in this process, its outputs under ``out``; returns
    run_variant's dict."""
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    if pkg == "dnsjax":
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        import ab_quality as ab
        import dnsjax.slam.driver as jdrv

        build, slam_cls = ab.build_variant_cfg, jdrv.DNSSLAM

        def build_gt(*a, **kw):
            cfg = build(*a, **kw)
            cfg["use_gt_camera"] = True
            return cfg

        class Here(slam_cls):  # run_variant's own output dir is fixed
            def __init__(self, cfg, output_dir=None):
                super().__init__(cfg, output_dir=out)

        ab.build_variant_cfg, jdrv.DNSSLAM = build_gt, Here
        os.system = lambda cmd: 0  # run_variant empties its fixed dir first
        return ab.run_variant(name, ab.VARIANTS[name], frames, True, 1, seed=seed,
                              protocol="kf")
    from dnsjax_torch.eval import ab_quality as ab

    return ab.run_variant(name, ab.VARIANTS[name], frames, True, 1, seed=seed, protocol="kf",
                          device=device, out=out, sets=["use_gt_camera=true"])


def _spawn(pkg: str, name: str, seed: int, frames: int, device: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", pkg, name,
                        str(seed), "--frames", str(frames), "--device", device, "--run-dir",
                        os.path.join(RUNS, f"{pkg}_{name}_s{seed}")],
                       capture_output=True, text=True, env=env, cwd=ROOT)
    line = next((ln for ln in p.stdout.splitlines() if ln.startswith("F7RESULT ")), None)
    if p.returncode != 0 or line is None:
        raise RuntimeError(f"{pkg} {name} seed {seed} failed ({p.returncode}):\n"
                           f"{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
    r = json.loads(line[len("F7RESULT "):])
    r.update(package=pkg, variant=name, seed=seed, process_s=time.perf_counter() - t0,
             device="cpu" if pkg == "dnsjax" else device)
    print(json.dumps(r), flush=True)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--one", nargs=3, metavar=("PKG", "VARIANT", "SEED"), default=None)
    ap.add_argument("--seeds", type=str, default="0,1,2")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--packages", type=str, default="dnsjax,port")
    ap.add_argument("--device", type=str, default="cuda", help="the port's device")
    ap.add_argument("--run-dir", type=str, default=None)
    ap.add_argument("--out", type=str, default=os.path.join(ROOT, "output",
                                                             "fault7_small.json"))
    args = ap.parse_args(argv)
    if args.one:
        pkg, name, seed = args.one
        r = _one(pkg, name, int(seed), args.frames, args.run_dir, args.device)
        print("F7RESULT " + json.dumps(r), flush=True)
        return r
    done = {}
    if os.path.exists(args.out):  # earlier calls' runs, merged
        with open(args.out) as f:
            done = {(r["package"], r["variant"], r["seed"]): r for r in json.load(f)["runs"]}
    runs = [(pkg, name, int(s), args.frames, args.device) for name in VARIANTS
            for s in args.seeds.split(",") for pkg in args.packages.split(",")
            if (pkg, name, int(s)) not in done]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    lock = threading.Lock()

    def run(r):
        res = _spawn(*r)
        with lock:
            done[(res["package"], res["variant"], res["seed"])] = res
            _write(args.out, done)
        return res

    with ThreadPoolExecutor(args.jobs) as ex:
        list(ex.map(run, runs))
    return _write(args.out, done)


def _write(path: str, done: dict) -> dict:
    """Write every run so far and the depth-L1 seed-means by package and
    variant to ``path``; print the means; return them."""
    results = sorted(done.values(), key=lambda r: (r["package"], r["variant"], r["seed"]))
    summary = {}
    for pkg in ("dnsjax", "port"):
        for name in VARIANTS:
            d = [r["depth_l1_cm"] for r in results if r["package"] == pkg and r["variant"] == name]
            if not d:
                continue
            summary[f"{pkg} {name}"] = dict(mean=sum(d) / len(d), min=min(d), max=max(d),
                                            seeds=[r["seed"] for r in results
                                                   if r["package"] == pkg and r["variant"] == name])
            print(f"{pkg:6s} {name:8s} depth L1 {sum(d) / len(d):.4f} cm "
                  f"({min(d):.4f}..{max(d):.4f}), {len(d)} seeds", flush=True)
    with open(path, "w") as f:
        json.dump(dict(runs=results, depth_l1_cm=summary), f, indent=1)
    return summary


if __name__ == "__main__":
    main()
