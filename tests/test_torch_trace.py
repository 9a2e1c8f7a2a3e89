"""The port's spans and counters (``dnsjax_torch/spans.py``) on the CPU.

Whole runs of the synthetic scene cut to 5 frames (``test_torch_driver.py``'s
short settings, with Adam tracking of 3 steps on 100 px and 100-ray
keysteps): off, the default, no span is kept and the poses are those of a
run with ``enable()``; on, the tracker's spans nest ``track.iter`` in
``track.solve`` in ``track`` in ``frame``, every span carries its frame,
there is one ``track.iter`` per iteration that ``metrics.jsonl`` counts,
and an asynchronous keystep's spans in its worker thread carry the frame
that dispatched it; under ``torch.profiler`` alone the exported trace holds
one ``dns.track`` range per tracked frame. Then the store's own rules: a
shared null span when off, a span open when the profiler stops, the cap,
and counters from many threads. Runtime budget: ~25 s on one core."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dnsjax_torch import spans
from dnsjax_torch.cli import run as t_run
from dnsjax_torch.slam.driver import DNSSLAM

torch.set_num_threads(1)
CONFIG = "configs/synthetic/synthetic.yaml"
SHORT = ["mapping.vis_every=0", "mapping.n_iters=4", "mapping.n_iters_first=6",
         "tracking.lm_iters=2", "mapping.n_pixels=100", "tracking.n_pixels=100",
         "tracking.method=adam", "tracking.n_iters=3"]
FRAMES = 5  # the bootstrap, frames 1-4 (2-4 tracked), keysteps at 3 and 4


def _run(out, how, *sets):
    """One run in ``out`` with tracing ``how`` (off, on, or under the
    profiler alone): its poses, kept spans and metrics.jsonl events."""
    cfg = t_run.load_run_config(CONFIG, 0, SHORT + list(sets))
    cfg["verbose"] = False
    spans.clear()
    slam = DNSSLAM(cfg, str(out), device="cpu")
    try:
        if how == "on":
            spans.enable()
            slam.run(end_frame=FRAMES)
        elif how == "profiler":
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                slam.run(end_frame=FRAMES)
            prof.export_chrome_trace(str(out / "trace.json"))
        else:
            slam.run(end_frame=FRAMES)
    finally:
        spans.disable()
    with open(out / "metrics.jsonl") as f:
        events = [json.loads(l) for l in f]
    return dict(poses=slam.estimate_c2w[:FRAMES].copy(), kept=spans.spans(), events=events,
                out=out, counters=spans.counters())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {how: _run(tmp_path_factory.mktemp(how), how)
            for how in ("off", "on", "profiler")}


def _tracked(run):
    return sorted(e["frame"] for e in run["events"] if e["event"] == "track")


def test_off_keeps_nothing_and_on_changes_no_pose(runs):
    assert runs["off"]["kept"] == [] and runs["on"]["kept"]
    np.testing.assert_array_equal(runs["off"]["poses"], runs["on"]["poses"])
    np.testing.assert_array_equal(runs["off"]["poses"], runs["profiler"]["poses"])
    # the bootstrap's counter is always on
    assert runs["off"]["counters"]["bootstrap.seconds"] > 0


def test_tracker_spans_nest_and_carry_their_frame(runs):
    kept = runs["on"]["kept"]
    by_id = {s.id: s for s in kept}
    assert all(s.frame is not None for s in kept)
    # one thread, strict schedule: every span lies in its parent and
    # carries its parent's frame
    for s in kept:
        if s.parent is not None:
            parent = by_id[s.parent]
            assert parent.frame == s.frame
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    iters = [s for s in kept if s.name == "track.iter"]
    assert iters
    for s in iters:
        names = [s.name]
        while names[-1] != "frame":
            s = by_id[s.parent]
            names.append(s.name)
        assert names == ["track.iter", "track.solve", "track", "frame"]
    assert sorted(s.frame for s in kept if s.name == "track") == _tracked(runs["on"]) \
        == [2, 3, 4]
    assert sorted(s.frame for s in kept if s.name == "keystep") == [3, 4]
    assert sorted(s.frame for s in kept if s.name == "frame") == [1, 2, 3, 4]
    assert sorted(s.frame for s in kept if s.name == "load") == [1, 2, 3, 4]
    assert [s.frame for s in kept if s.name == "bootstrap"] == [0]


def test_one_iter_span_per_iteration_run(runs):
    kept, events = runs["on"]["kept"], runs["on"]["events"]
    n_run = sum(int(e["n_iters_run"]) for e in events if e["event"] == "track")
    assert n_run == 3 * 3
    assert sum(s.name == "track.iter" for s in kept) == n_run
    # the bootstrap's 6 mapping iterations, then 2 + 2 in each keystep
    assert sum(s.name == "map.iter" for s in kept) == 6 + 2 * 4


def test_profiler_alone_records_one_track_range_per_frame(runs):
    run = runs["profiler"]
    with open(run["out"] / "trace.json") as f:
        trace = json.load(f)["traceEvents"]
    ranges = [e for e in trace if e.get("ph") == "X" and e.get("name") == "dns.track"]
    assert len(ranges) == len(_tracked(run)) == 3
    assert sum(s.name == "track" for s in run["kept"]) == 3


def test_async_keystep_spans_carry_their_dispatch_frame(tmp_path):
    run = _run(tmp_path, "on", "tpu.async_map=true")
    kept = run["kept"]
    main = {s.thread for s in kept if s.name == "frame"}
    assert len(main) == 1
    worker = [s for s in kept if s.thread not in main]
    # the keysteps dispatched at frames 3 and 4 ran their calls in the worker
    assert sorted({s.frame for s in worker if s.name == "map.call"}) == [3, 4]
    assert {s.frame for s in worker} == {3, 4}
    assert sum(s.name == "map.iter" for s in worker) == 2 * 4


def test_off_span_is_shared_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("an off span read the clock")

    monkeypatch.setattr(spans.time, "perf_counter_ns", no_clock)
    spans.clear()
    assert spans.span("a") is spans.span("b", frame=3)
    with spans.span("a"):
        pass
    assert spans.spans() == []


def test_span_open_when_the_profiler_stops_closes(tmp_path):
    spans.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with spans.span("outer", frame=7):
        with spans.span("inner"):
            torch.ones(3).sum()
        prof.stop()
        with spans.span("after"):  # entered off: not kept
            pass
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    kept = spans.spans()
    assert [(s.name, s.frame) for s in kept] == [("inner", 7), ("outer", 7)]
    assert kept[0].parent == kept[1].id and kept[1].parent is None
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"dns.outer", "dns.inner"} <= names and "dns.after" not in names


def test_store_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "MAX_SPANS", 2)
    spans.clear()
    spans.enable()
    try:
        for _ in range(5):
            with spans.span("x"):
                pass
    finally:
        spans.disable()
    assert len(spans.spans()) == 2 and spans.counters()["spans.dropped"] == 3


def test_counters_add_from_many_threads():
    spans.clear()
    n_threads, n_adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [spans.count("c") for _ in range(n_adds)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert spans.counters()["c"] == n_threads * n_adds
    spans.clear()
    assert spans.counters() == {}


def test_tally_holds_back_this_thread_s_counts():
    """Inside ``tally`` this thread's counts add to the block's dict (the
    inner block's to its own), another thread's still reach the counters."""
    spans.clear()
    with spans.tally() as outer:
        spans.count("a", 2)
        with spans.tally() as inner:
            spans.count("a")
        t = threading.Thread(target=spans.count, args=("b", 5))
        t.start()
        t.join(timeout=60)
        spans.count("a")
    spans.count("c")
    assert outer == {"a": 3} and inner == {"a": 1}
    assert spans.counters() == {"b": 5, "c": 1}
    spans.clear()


def test_tally_of_a_stream_holds_back_other_threads_counts_on_it(monkeypatch):
    """Inside ``tally(stream)`` another thread's counts on that stream add to
    the block's dict (as autograd's CUDA thread runs a captured backward on
    the capture's stream); on another stream, or after the block, they reach
    the counters. The threads' streams are stand-ins: there is no card here."""
    class Stream:
        cuda_stream = 7

    local = threading.local()
    monkeypatch.setattr(spans, "_stream_key", lambda: getattr(local, "stream", 0))

    def count_on(stream, name):
        local.stream = stream
        spans.count(name)

    def in_thread(stream, name):
        t = threading.Thread(target=count_on, args=(stream, name))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()

    spans.clear()
    with spans.tally(Stream()) as held:
        spans.count("a")
        in_thread(7, "b")
        in_thread(8, "c")
    in_thread(7, "d")
    assert held == {"a": 1, "b": 1}
    assert spans.counters() == {"c": 1, "d": 1}
    assert spans._stream_tallies == {}
    spans.clear()
