"""The benchmark's own spans and ranges around the port's layers, and the
reading of the profiler's trace.

Spans (host clock) wrap each call of the dataset's ``__getitem__``
(``load``), ``DNSSLAM.track_frame`` (``track``) and ``DNSSLAM._keystep``
(``keystep``) over the whole window. Under the profiler each span is also a
``record_function`` range (``bench.<name>``), and so is each call of the
port's public ``hash_encode`` (``bench.encode``; ``bench.encode_jvp`` under
the tracker's forward-mode transforms, whose tangent it also computes) and
its backward (``bench.encode_bwd``), routed through the port's
``grid_encode_override``. The profiler covers the window's first mapping
period only: it starts at the period's first load and stops when its
keystep returns.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._C._functorch import peek_interpreter_stack
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host spans of the window, (name, start, end, frame) in perf_counter
    seconds; with ``ranges`` each also a profiler range."""

    def __init__(self, ranges: bool):
        self.ranges = ranges
        self.items: List[Tuple[str, float, float, int]] = []

    def wrap(self, name: str, fn: Callable, frame_of: Callable = lambda *a: -1,
             after: Optional[Callable] = None) -> Callable:
        def call(*args, **kwargs):
            frame = frame_of(*args)
            t0 = time.perf_counter()
            if self.ranges:
                with record_function(f"bench.{name}"):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            self.items.append((name, t0, time.perf_counter(), frame))
            if after is not None:
                after(frame)
            return out

        return call


class DatasetSpans:
    """The dataset with each ``__getitem__`` in a ``load`` span; ``before``
    runs first with the frame index."""

    def __init__(self, dataset, spans: Spans, before: Callable[[int], None]):
        self._ds = dataset
        self._get = spans.wrap("load", dataset.__getitem__, frame_of=lambda i: int(i))
        self._before = before

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        self._before(int(i))
        return self._get(i)

    def __getattr__(self, name):
        return getattr(self._ds, name)


class _RangedEncode(torch.autograd.Function):
    """``hash_encode`` in a range, and its backward in another: the inner
    call builds its own graph on detached inputs, whose gradient the
    backward takes inside ``bench.encode_bwd``."""

    @staticmethod
    def forward(ctx, table, pts, spec, encode, log):
        t = table.detach().requires_grad_(ctx.needs_input_grad[0])
        p = pts.detach().requires_grad_(ctx.needs_input_grad[1])
        with torch.enable_grad(), record_function("bench.encode"):
            out = encode(t, p, spec)
        log("fwd", p, True)
        ctx.inner, ctx.log = (t, p, out), log
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        t, p, out = ctx.inner
        ins = [x for x in (t, p) if x.requires_grad]
        with record_function("bench.encode_bwd"):
            grads = list(torch.autograd.grad(out, ins, g))
        ctx.log("bwd", p, p.requires_grad)
        gt = grads.pop(0) if t.requires_grad else None
        gp = grads.pop(0) if p.requires_grad else None
        ctx.inner = None
        return gt, gp, None, None, None


class EncodeRanges:
    """The grid encode that ``pos_encode`` calls while tracing: the port's
    ``hash_encode`` inside the benchmark's ranges. While ``recording``,
    each forward's points and residual flag and each backward's point count
    are kept for the bytes bounds."""

    def __init__(self, encode: Callable):
        self.encode = encode
        self.recording = False
        self.forward: List[Tuple[torch.Tensor, bool]] = []
        self.backward: List[Tuple[int, bool]] = []

    def _log(self, kind: str, pts: torch.Tensor, flag: bool) -> None:
        if not self.recording:
            return
        if kind == "fwd":
            self.forward.append((pts.detach().reshape(-1, 3).clone(), flag))
        else:
            self.backward.append((int(pts.reshape(-1, 3).shape[0]), flag))

    def __call__(self, table, pts, spec):
        if peek_interpreter_stack() is not None:
            with record_function("bench.encode_jvp"):
                return self.encode(table, pts, spec)
        if not torch.is_grad_enabled() or not (table.requires_grad or pts.requires_grad):
            with record_function("bench.encode"):
                out = self.encode(table, pts, spec)
            self._log("fwd", pts, torch.is_grad_enabled())
            return out
        return _RangedEncode.apply(table, pts, spec, self.encode, self._log)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Profiler:
    """torch.profiler over one stretch of the window, started and stopped
    by the spans' callbacks; ``read`` parses its trace afterwards."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.on = self.done = False
        self.t0 = self.t1 = self.t2 = 0.0  # start, stop, and when the stop returned

    def start(self) -> None:
        if not self.on and not self.done:
            _sync()
            self.prof.start()
            self.on, self.t0 = True, time.perf_counter()

    def stop(self) -> None:
        if self.on:
            _sync()
            self.t1 = time.perf_counter()
            self.prof.stop()
            self.on, self.done = False, True
            self.t2 = time.perf_counter()

    def read(self, path: str) -> Dict[str, Any]:
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        return parse_trace(events, self.t1 - self.t0)


def parse_trace(events: List[Dict[str, Any]], window_s: float) -> Dict[str, Any]:
    """Device operations (name, start us, duration us, launch us or None)
    and the benchmark's ranges (name, start us, end us) of a chrome trace."""
    launch: Dict[int, float] = {}
    ops, ranges = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            ops.append([e.get("name", "?"), float(e["ts"]), float(e.get("dur", 0.0)), corr])
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch[corr] = float(e["ts"])
        elif cat == "user_annotation" and str(e.get("name", "")).startswith("bench."):
            ranges.append((e["name"][6:], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for op in ops:
        op[3] = launch.get(op[3])
    return {"ops": [tuple(o) for o in ops], "ranges": ranges, "window_s": window_s}


def ops_in(trace: Dict[str, Any], name: str) -> List[tuple]:
    """The device operations launched inside any ``bench.<name>`` range."""
    spans = sorted((a, b) for n, a, b in trace["ranges"] if n == name)
    if not spans:
        return []
    import bisect

    starts = [a for a, _ in spans]
    out = []
    for op in trace["ops"]:
        t = op[3]
        if t is None:
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and spans[k][0] <= t <= spans[k][1]:
            out.append(op)
    return out


def busy_intervals(trace: Dict[str, Any]) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, in us."""
    merged: List[List[float]] = []
    for _, ts, dur, _ in sorted(trace["ops"], key=lambda o: o[1]):
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ts + dur)
        else:
            merged.append([ts, ts + dur])
    return [(a, b) for a, b in merged]
