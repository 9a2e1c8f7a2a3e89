"""The program's own spans (``dnsjax_torch/spans.py``) on the trace's clock,
and the device's idle time of the traced period split by the host layer
the program was in.

The program keeps its spans in memory while the profiler runs (tracing is
off otherwise), so after a ``--trace 1`` run its store holds the traced
period's. Each of the benchmark's ``bench.track`` ranges encloses exactly
one of the program's ``track`` spans: matched in order, each pair bounds
the offset from the program's clock (``perf_counter_ns``) to the trace's
(us) from below (range start - span start) and from above (range end -
span end), and the offset is the middle of the tightest bounds. (A
start alone misleads: the process's first profiler range takes ~1 ms to
enter, so the first pair's starts lie that far apart.) A program without
the spans module (nothing to read), a store that dropped spans, counts
that differ, or bounds more than ``MAX_SPREAD_US`` apart either way give
None.

The idle split takes the device's idle intervals between the traced
period's first and last device operation (the gaps between
``busy_intervals``) and charges each instant to the outermost of the
program's ``load``, ``track`` and ``keystep`` spans open on the host then
(the earliest started of those open), or to the driver where none is.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark.trace import busy_intervals

LAYERS = ("load", "track", "keystep")
MAX_SPREAD_US = 500.0

_memo: Tuple[object, object] = (None, None)


def recorded():
    """(the program's kept spans, its counters), or None where the program
    keeps none."""
    try:
        from dnsjax_torch import spans
    except ImportError:
        return None
    return spans.spans(), spans.counters()


def aligned(ctx) -> Optional[List[Tuple[object, float, float]]]:
    """The program's kept spans as (span, start us, end us) on the trace's
    clock, or None."""
    got = recorded()
    if ctx["trace"] is None or got is None:
        return None
    kept, counters = got
    if counters.get("spans.dropped"):
        return None
    bench = sorted((a, b) for n, a, b in ctx["trace"]["ranges"] if n == "track")
    prog = sorted((s.start_ns / 1e3, s.end_ns / 1e3) for s in kept if s.name == "track")
    if not bench or len(bench) != len(prog):
        return None
    lo = max(ba - pa for (ba, _), (pa, _) in zip(bench, prog))
    hi = min(bb - pb for (_, bb), (_, pb) in zip(bench, prog))
    if abs(hi - lo) > MAX_SPREAD_US:
        return None
    off = (lo + hi) / 2
    return [(s, s.start_ns / 1e3 + off, s.end_ns / 1e3 + off) for s in kept]


def _segments(layer: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """Disjoint (start, end, name) pieces, sorted, each instant of the
    spans given to the earliest started span open then."""
    out, end = [], float("-inf")
    for a, b, name in sorted(layer):
        a = max(a, end)
        if b > a:
            out.append((a, b, name))
            end = b
    return out


def split(busy: List[Tuple[float, float]], layer: List[Tuple[float, float, str]]
          ) -> Dict[str, float]:
    """The idle us between the ``busy`` intervals (sorted, disjoint) by the
    outermost ``layer`` span open at each instant, else ``driver``."""
    segs = _segments(layer)
    out = dict.fromkeys(LAYERS + ("driver",), 0.0)
    k = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        covered, j = 0.0, k
        while j < len(segs) and segs[j][0] < b:
            part = min(b, segs[j][1]) - max(a, segs[j][0])
            out[segs[j][2]] += part
            covered += part
            j += 1
        out["driver"] += (b - a) - covered
    return out


def idle_split(ctx) -> Optional[Dict[str, float]]:
    """``split`` of the traced period by the program's aligned spans, in
    us (once per ``ctx``), or None."""
    global _memo
    if _memo[0] is not ctx:
        spans = aligned(ctx)
        result = None
        if spans is not None:
            busy = busy_intervals(ctx["trace"])
            if busy:
                result = split(busy, [(a, b, s.name) for s, a, b in spans if s.name in LAYERS])
        _memo = (ctx, result)
    return _memo[1]


def idle_ms(ctx, where: str) -> Optional[float]:
    """The device's idle ms per traced frame while the host is in
    ``where`` (a layer of ``LAYERS`` or ``driver``)."""
    parts = idle_split(ctx)
    if parts is None or not ctx["traced_frames"]:
        return None
    return parts[where] / 1e3 / ctx["traced_frames"]
