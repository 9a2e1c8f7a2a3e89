"""The program's spans on the trace's clock and the idle split
(``benchmark/program_spans.py``) and its six readers, on canned spans and
a canned trace, and the alignment on a real profiler trace of the CPU."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import program_spans
from benchmark.run import load_reader
from benchmark.trace import Spans, parse_trace
from dnsjax_torch import spans as prog
from dnsjax_torch.spans import Span

OFF_US = 5_000_000.0  # the trace's clock minus the program's, in us
IDLE = ("load.idle_ms", "track.idle_ms", "keystep.idle_ms", "driver.idle_ms")
SIX = IDLE + ("track.readback_ms", "setup.bootstrap_s")


def _span(i, name, a, b, parent=None, frame=11):
    """A program span over [a, b] us of the trace's clock."""
    return Span(i, name, int((a - OFF_US) * 1e3), int((b - OFF_US) * 1e3), parent, 1, frame)


def _canned():
    """Two tracked frames and a keystep, in trace us: frame 11 tracks over
    [0, 1000] (idle [200, 300], [400, 900] inside), then the driver, frame
    12's load over [1100, 2100] and its upload's copy at 2150, so one gap
    runs from the tracker's last kernel (950) through the load; frame 12
    tracks over [2300, 3300]; its keystep runs over [3400, 4400]."""
    kept = [
        _span(0, "track.readback", 900, 990, 1), _span(1, "track", 0, 1000),
        _span(2, "load", 1100, 2100, frame=12), _span(3, "upload", 2100, 2200, frame=12),
        _span(4, "track.iter", 2350, 2600, 5, 12), _span(5, "track", 2300, 3300, frame=12),
        _span(6, "track.readback", 3200, 3290, 5, 12),
        _span(7, "map.call", 3450, 4300, 8, 12), _span(8, "keystep", 3400, 4400, frame=12),
    ]
    ops = [(f"k{i}", a, b - a, None) for i, (a, b) in enumerate([
        (100, 200), (300, 400), (900, 950), (2150, 2250), (2400, 2500), (3200, 3250),
        (3500, 4000), (4100, 4390)])]
    ranges = [("track", 0.0, 1000.0), ("load", 1095.0, 2101.0), ("track", 2300.0, 3300.0),
              ("keystep", 3399.0, 4401.0)]
    trace = {"ops": ops, "ranges": ranges, "window_s": 0.0045}
    return kept, dict(trace=trace, traced_frames=2)


@pytest.fixture
def canned(monkeypatch):
    kept, ctx = _canned()
    counters = {"bootstrap.seconds": 31.5}
    monkeypatch.setattr(program_spans, "recorded", lambda: (kept, counters))
    return kept, ctx


def test_alignment_matches_anchors_in_order(canned):
    kept, ctx = canned
    got = program_spans.aligned(ctx)
    starts = {s.id: a for s, a, _ in got}
    assert starts[1] == pytest.approx(0.0) and starts[5] == pytest.approx(2300.0)
    # ranges that lead by 2 us and trail by 4 place the spans in the middle
    ctx["trace"]["ranges"] = [(n, a - 2.0, b + 4.0) for n, a, b in ctx["trace"]["ranges"]]
    got = program_spans.aligned(ctx)
    assert {s.id: a for s, a, _ in got}[2] == pytest.approx(1101.0)
    # one slow start (the process's first range) loosens one bound alone
    ctx["trace"]["ranges"][0] = ("track", -1000.0, 1004.0)
    assert {s.id: a for s, a, _ in program_spans.aligned(ctx)}[2] == pytest.approx(1101.0)


def test_alignment_refuses_mismatched_anchors(canned, monkeypatch):
    kept, ctx = canned
    one = dict(ctx, trace=dict(ctx["trace"], ranges=ctx["trace"]["ranges"][:1]))
    assert program_spans.aligned(one) is None  # 1 range against 2 spans
    late = 600.0  # the second pair's clocks 0.6 ms off the first's
    spread = [(n, a + late * (a > 2000), b + late * (a > 2000))
              for n, a, b in ctx["trace"]["ranges"]]
    assert program_spans.aligned(dict(ctx, trace=dict(ctx["trace"], ranges=spread))) is None
    assert program_spans.aligned(dict(ctx, trace=None)) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: (kept, {"spans.dropped": 1}))
    assert program_spans.aligned(ctx) is None


def test_gap_from_track_through_load_is_the_load_s():
    # one gap [950, 2150]: 50 us in track, 100 driver, the load's 1000, 50 driver
    parts = program_spans.split([(0, 950), (2150, 2250)],
                                [(0, 1000, "track"), (1100, 2100, "load")])
    assert parts == {"load": 1000.0, "track": 50.0, "keystep": 0.0, "driver": 150.0}


def test_outermost_open_span_takes_the_instant():
    # a keystep that holds a load, and a track another thread opened inside
    parts = program_spans.split([(0, 0), (1000, 1000)],
                                [(0, 800, "keystep"), (100, 200, "load"),
                                 (500, 900, "track")])
    assert parts == {"keystep": 800.0, "track": 100.0, "load": 0.0, "driver": 100.0}


def test_six_readers(canned):
    _, ctx = canned
    r = {m: load_reader(m)(ctx) for m in SIX}
    assert r["track.idle_ms"] == pytest.approx((100 + 500 + 50 + 100 + 700 + 50) / 2e3)
    assert r["load.idle_ms"] == pytest.approx(1000 / 2e3)
    assert r["keystep.idle_ms"] == pytest.approx((100 + 100) / 2e3)
    assert r["driver.idle_ms"] == pytest.approx((100 + 50 + 50 + 100) / 2e3)
    assert r["track.readback_ms"] == pytest.approx(0.09)
    assert r["setup.bootstrap_s"] == 31.5


def test_idle_readers_sum_to_the_trace_idle(canned):
    _, ctx = canned
    ops = ctx["trace"]["ops"]
    first, last = min(o[1] for o in ops), max(o[1] + o[2] for o in ops)
    idle_us = (last - first) - sum(o[2] for o in ops)  # the canned ops do not overlap
    total = sum(load_reader(m)(ctx) for m in IDLE) * ctx["traced_frames"]
    assert total == pytest.approx(idle_us / 1e3) and idle_us == 3000


def test_readers_find_nothing_without_the_program_s_spans(monkeypatch):
    """A program without the spans module (the parent of this reader's
    change): every reader returns None and none raises."""
    _, ctx = _canned()
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    for m in SIX:
        assert load_reader(m)(ctx) is None, m


def test_alignment_on_a_real_trace(tmp_path):
    """The benchmark's ``bench.track`` range around a method whose body is
    the program's ``track`` span, under the profiler on the CPU: the
    program's clock meets the trace's to within the tolerance, and each
    program span lands inside its range."""
    bench = Spans(ranges=True)

    def track_frame(i):
        with prog.span("track", frame=i):
            torch.ones(64).sum()

    wrapped = bench.wrap("track", track_frame, lambda i: i)
    prog.clear()
    p = profile(activities=[ProfilerActivity.CPU])
    p.start()
    for i in range(5):
        wrapped(i)
    p.stop()
    p.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        trace = parse_trace(json.load(f)["traceEvents"], 1.0)
    got = program_spans.aligned(dict(trace=trace, traced_frames=5))
    prog.clear()
    assert got is not None and len(got) == 5
    ranges = sorted((a, b) for n, a, b in trace["ranges"] if n == "track")
    for (s, a, b), (ra, rb) in zip(sorted(got, key=lambda g: g[1]), ranges):
        assert ra - 50 <= a <= b <= rb + 50
