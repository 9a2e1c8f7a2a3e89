"""The benchmark of dnsjax_torch: frames per second of the SLAM loop on one
H100, on RGB-D sequences written from the seed in the datasets' own
formats and read through the port's own loaders.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A run: start torch; write the cell's sequence under ``$TMPDIR``; build
``DNSSLAM`` through its real entry; warm up with ``run(end_frame=11)`` (the
500-iteration bootstrap on frame 0 and frames 1-10, whose frame 10 maps),
which runs every shape the window runs; then the window, one call
``run(start_frame=11, end_frame=11 + nk)`` over k whole mapping periods of
n frames (``optimize_every_n_frames``), k the most periods that fit in
``--seconds`` at the traffic file's nominal period and closing checkpoint,
and at least one: the same frames in every run of one ``--seconds``. The
sequence written holds the frames that window reaches and no more. Set-up is
everything from the process's start to the window's. After the window the
benchmark reruns one mapping call and one tracked call of it with the
plain reference (``benchmark/follow.py``) and prints each number beside its
limit, then the result as the last line of standard output.

``--trace 1`` reports the cell's per-layer metrics instead of its end-to-end
ones: the readers in ``benchmark/metrics/`` read the benchmark's spans, the
port's ``metrics.jsonl`` and the profiler's trace of the window's first
mapping period. ``--control 1`` puts the control, the reference at
bfloat16, in the program's place: ``checks`` and ``correct`` come from its
numbers, and the program's own and those of faults planted in the
reference are printed beside them (set-up of the limits; the timed runs
never do).

Everything about a cell is data: ``BENCHMARK.json`` names it, its
configuration is ``benchmark/configs/<config>.json`` and its traffic
``benchmark/workloads/<traffic>.json``; each per-layer metric is read by
``benchmark/metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX_MODULES = ("jax", "jaxlib", "flax", "dnsjax")
WARMUP_END = 11  # the bootstrap on frame 0, then frames 1-10 (frame 10 maps)


def window_periods(seconds: float, traffic) -> int:
    """The window's mapping periods: as many as fit in ``seconds`` at the
    traffic's nominal period and closing checkpoint, and at least one, so
    that one ``--seconds`` gives every run the same frames."""
    return max(1, int((seconds - float(traffic["checkpoint_s"])) // float(traffic["period_s"])))


def process_start() -> float:
    """The wall-clock time this process started (from /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(float(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def fail(msg: str, code: int = 1) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def jax_loaded(names=None) -> list:
    """The top-level names among ``names`` (default: the process's loaded
    modules) that are JAX's or its package's, compared whole:
    ``dnsjax_torch`` is not ``dnsjax``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(JAX_MODULES))


def load_bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(name: str):
    """(workload entry, configuration file, traffic file, BENCHMARK.json)."""
    bench = load_bench()
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        fail(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "workloads", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return cell, config, traffic, bench


def run_config(config, traffic, seed: int, folder: str):
    """The port's config dict: the configuration's, the traffic's keys over
    it, the seed and the sequence's folder."""
    cfg = json.loads(json.dumps(config["config"]))
    for k, v in traffic.get("config", {}).items():
        cfg[k] = v
    cfg["seed"] = int(seed)
    cfg["input_folder"] = folder
    return cfg


def read_events(path: str, skip: int):
    with open(path) as f:
        lines = f.readlines()
    return [json.loads(l) for l in lines[skip:]]


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def main(argv=None) -> None:
    t_process = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--control", type=int, default=0, choices=(0, 1))
    p.add_argument("--device", default="cuda", help="cuda; cpu only for the tests")
    args = p.parse_args(argv)

    # one process with few threads: the loop is bound by one host thread's
    # launches, and idle pool threads spinning beside it only add noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    import cv2

    cv2.setNumThreads(1)
    cell, config, traffic, bench = load_cell(args.workload)
    result = execute(cell, config, traffic, bench["per_layer"], args, t_process)
    found = jax_loaded()
    if found:
        fail(f"JAX modules are loaded in this process: {found}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def execute(cell, config, traffic, per_layer, args, t_process: float):
    """One run of ``cell``; returns the result (its ``checks`` last)."""
    import torch

    on_card = args.device == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        fail(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
             f"{torch.cuda.is_available()}, {torch.cuda.device_count()} present", 2)
    sys.path.insert(0, ROOT)
    from dnsjax_torch.models.decoder import grid_encode_override, hash_encode
    from dnsjax_torch.slam.driver import DNSSLAM

    from benchmark import counts, follow, sequence
    from benchmark.reference.frames import Frames
    from benchmark.trace import DatasetSpans, EncodeRanges, Profiler, Spans

    dev = torch.device(args.device)
    work = os.path.join(os.environ.get("TMPDIR") or os.path.join(ROOT, ".benchmark_tmp"),
                        f"benchmark_{args.workload}")
    folder, out = os.path.join(work, "sequence"), os.path.join(work, "output")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(out)
    fmt = traffic["format"]
    cfg = run_config(config, traffic, args.seed, folder)
    every = int(cfg["mapping"]["optimize_every_n_frames"])
    k = window_periods(args.seconds, traffic)
    n_written = min(int(traffic["frames_written"]), WARMUP_END + every * k)
    t0 = time.perf_counter()
    n_bytes = sequence.write_sequence(folder, fmt, cfg["cam"], n_written, args.seed, dev)
    t_write = time.perf_counter() - t0

    slam = DNSSLAM(cfg, out, device=args.device)
    tracking = not bool(cfg.get("use_gt_camera", False))
    most = (slam.n_img - WARMUP_END) // every  # the periods the sequence holds
    follower = follow.Follower(args.seed, tracking)
    follower.install(slam)
    ckpt_s = []  # the closing checkpoints' walls, which a window holds once
    save = slam.save_checkpoint

    def timed_save(*a, **kw):
        t = time.perf_counter()
        save(*a, **kw)
        ckpt_s.append(time.perf_counter() - t)

    slam.save_checkpoint = timed_save
    t0 = time.perf_counter()
    slam.run(end_frame=WARMUP_END)
    if on_card:
        torch.cuda.synchronize()
    boot_s = slam.map_times[0]
    period_s = time.perf_counter() - t0 - boot_s - ckpt_s[0]
    if k > most:
        k = max(1, most)
        print(f"benchmark: the sequence ends after {k} period(s) of the window",
              file=sys.stderr)
    end = WARMUP_END + every * k
    n_warm_events = len(read_events(os.path.join(out, "metrics.jsonl"), 0))
    follower.draw_window(2 * k, end - WARMUP_END)
    spans = Spans(ranges=bool(args.trace))
    prof = encode = None
    if args.trace:
        prof, encode = Profiler(), EncodeRanges(hash_encode)

        def before_load(i):
            if i == WARMUP_END:
                prof.start()
                encode.recording = True

        def after_keystep(_):
            if prof.on:
                prof.stop()
                encode.recording = False

        slam.dataset = DatasetSpans(slam.dataset, spans, before_load)
        slam.track_frame = spans.wrap("track", slam.track_frame, lambda i, c: i)
        slam._keystep = spans.wrap("keystep", slam._keystep, lambda i, c: i, after_keystep)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - t_process
    t_win = time.perf_counter()
    if args.trace:
        with grid_encode_override(encode):
            slam.run(start_frame=WARMUP_END, end_frame=end)
    else:
        slam.run(start_frame=WARMUP_END, end_frame=end)
    if on_card:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    wall = t_end - t_win
    frames = end - WARMUP_END
    mem_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    events = read_events(os.path.join(out, "metrics.jsonl"), n_warm_events)
    H, W, n_class = slam.dataset.H, slam.dataset.W, slam.n_class
    grid_spec = follow.reference_spec(cfg, slam.bound_np, n_class, torch.float32).grid
    failed = sum(1 for e in events if e.get("event") == "track"
                 and not math.isfinite(float(e.get("best_loss", 0.0))))
    del slam
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the comparison with the reference, once the program's state is freed
    if None in (follower.start, follower.keystep) or (tracking and follower.tracked is None):
        fail("a followed mapping call or tracked call never ran")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_frames = Frames(folder, fmt, cfg["cam"])
    t0 = time.perf_counter()
    numbers = follow.numbers(follower, cfg, ref_frames, end, faults=bool(args.control))
    check_s = time.perf_counter() - t0
    control = follow.numbers(follower, cfg, ref_frames, end, torch.bfloat16) \
        if args.control else None
    limits = traffic["limits"]
    judged = control if args.control else numbers
    checks = {k: {"value": judged[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": int(cell["chips"]), "memory_peak_bytes": mem_peak}
    result = {"correct": correct, "attempted": frames, "failed": failed}
    if args.trace:
        trace = prof.read(os.path.join(work, "trace.json")) if prof.done else None
        traced_end = WARMUP_END + every - 1  # the traced period's keystep frame
        later = [s for s in spans.items if s[1] >= prof.t2] if k > 1 else spans.items
        ctx = dict(
            cfg=cfg, n_class=n_class, H=H, W=W, grid_spec=grid_spec,
            peaks=json.load(open(os.path.join(HERE, "peaks.json"))), trace=trace,
            spans=later, host_wall=t_end - prof.t2 if k > 1 else wall,
            events=[e for e in events if k == 1 or e.get("frame", end) > traced_end],
            traced_frames=sum(1 for s in spans.items if s[0] == "track"
                              and WARMUP_END <= s[3] <= traced_end),
            traced_keysteps=sum(1 for s in spans.items if s[0] == "keystep"
                                and s[3] <= traced_end),
            encode_fwd=[(int(p.shape[0]), res, counts.unique_rows(grid_spec, p))
                        for p, res in encode.forward],
            encode_bwd=list(encode.backward))
        metrics = {}
        for m in per_layer:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        from benchmark.trace import busy_intervals

        busy = busy_intervals(trace)
        device["busy_s"] = sum(b - a for a, b in busy) / 1e6
        device["window_s"] = trace["window_s"]
        result["breakdown"] = breakdown(trace, busy)
    else:
        metrics = {"fps": {"value": frames / wall, "unit": "frames/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    result.update(metrics=metrics, device=device)
    shutil.rmtree(work, ignore_errors=True)

    tracks = [e for e in events if e.get("event") == "track"]
    info = dict(k=k, frames=frames, window_s=wall, warmup_period_s=period_s,
                checkpoint_s=ckpt_s, bootstrap_s=boot_s,
                retried=sum(bool(e.get("retried")) for e in tracks),
                track_iters=sum(int(e.get("n_iters_run", 0)) for e in tracks),
                decoder_inits=sum(e.get("event") == "decoder_init" for e in events),
                sequence_bytes=n_bytes, sequence_write_s=t_write, check_s=check_s,
                followed_map_call=follower.map_call, followed_track_call=follower.track_call,
                card=power_limit() if on_card else "cpu", numbers=numbers, control=control)
    info["process_s"] = time.time() - t_process
    print("benchmark: " + json.dumps(info), file=sys.stderr)
    result["checks"] = checks
    return result


def breakdown(trace, busy):
    """The device operations that took most time, and the longest idle
    gaps, each named by the benchmark range the host was in at its start."""
    by_name = {}
    for name, _, dur, _ in trace["ops"]:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted((a, b, n) for n, a, b in trace["ranges"]
                  if n in ("load", "track", "keystep"))
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        where = next((n for a, b, n in host if a <= e0 <= b), "driver")
        gaps.append((where, (s1 - e0) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:80], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}


if __name__ == "__main__":
    main()
