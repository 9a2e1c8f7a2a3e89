"""The program's spans on the trace's clock in a cell that tracks no frame,
and the device operations launched inside them.

``benchmark/program_spans.py`` aligns the program's spans (``dnsjax_torch/
spans.py``) on the benchmark's ``bench.track`` ranges, and a cell with
known poses has none. Here each kind of span that one of the benchmark's
ranges encloses one for one bounds the offset in the same way: the
benchmark wraps ``track_frame`` and ``_keystep``, whose bodies open the
program's ``track`` and ``keystep`` spans, so each pair, matched in order,
bounds the offset from the program's clock to the trace's from below
(range start - span start) and from above (range end - span end), and the
offset is the middle of the tightest bounds. No pair, counts that differ, a
store that dropped spans, or bounds more than ``MAX_SPREAD_US`` apart give
None, as there.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from benchmark.program_spans import MAX_SPREAD_US, recorded

ANCHORS = ("track", "keystep")

_memo: Tuple[object, object] = (None, None)


def aligned(ctx) -> Optional[List[Tuple[object, float, float]]]:
    """The program's kept spans as (span, start us, end us) on the trace's
    clock (once per ``ctx``), or None."""
    global _memo
    if _memo[0] is not ctx:
        _memo = (ctx, _align(ctx))
    return _memo[1]


def _align(ctx):
    got = recorded()
    if ctx["trace"] is None or got is None:
        return None
    kept, counters = got
    if counters.get("spans.dropped"):
        return None
    lo, hi, pairs = float("-inf"), float("inf"), 0
    for name in ANCHORS:
        bench = sorted((a, b) for n, a, b in ctx["trace"]["ranges"] if n == name)
        prog = sorted((s.start_ns / 1e3, s.end_ns / 1e3) for s in kept if s.name == name)
        if len(bench) != len(prog):
            return None
        for (ba, bb), (pa, pb) in zip(bench, prog):
            lo, hi = max(lo, ba - pa), min(hi, bb - pb)
            pairs += 1
    if not pairs or abs(hi - lo) > MAX_SPREAD_US:
        return None
    off = (lo + hi) / 2
    return [(s, s.start_ns / 1e3 + off, s.end_ns / 1e3 + off) for s in kept]


def named(spans, name: str, tag: Optional[str] = None) -> List[Tuple[object, float, float]]:
    """The aligned spans called ``name`` (with ``tag``, where given)."""
    return [x for x in spans if x[0].name == name
            and (tag is None or getattr(x[0], "tag", None) == tag)]


def ops_launched_in(trace, intervals) -> List[tuple]:
    """The device operations whose launch lies inside any of ``intervals``
    ((start us, end us), in any order; overlaps count once)."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    out = []
    for op in trace["ops"]:
        t = op[3]
        if t is None:
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= merged[k][1]:
            out.append(op)
    return out


def device_s(trace, intervals) -> float:
    """Device seconds of the operations launched inside ``intervals``."""
    return sum(op[2] for op in ops_launched_in(trace, intervals)) / 1e6
