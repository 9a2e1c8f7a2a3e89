"""The port's own spans and counters: where the loop's host time goes, and
how often its kernels launch.

``span(name, frame=None, tag=None)`` is a context manager placed where the
work happens (the driver's frame, load, upload, track, keystep, keyframe,
checkpoint and log; the tracker's encode, solve, iterations and readback;
the mapping calls, their iterations, TV terms and Adam updates; the grid
encode and its backward, whose span carries the tag ``map.smooth`` when
its forward ran inside that span, and holds ``encode_bwd.pos`` where it
takes a point gradient).
``count(name, n=1)`` adds to a counter; the kernels' launch counts,
``bootstrap.seconds``, ``map.smooth.points`` (the TV terms' points),
``pose.known`` (frames whose pose came from the dataset), the tracker's
``track.solves`` / ``track.graph.*`` and the keystep's ``map.iters`` (its
mapping iterations), ``map.graph.captures`` and ``map.graph.replays`` (the
iterations that replayed its captured pieces) live here. Inside
``tally()`` a thread's counts go to the block's own dict instead (a CUDA
graph's capture records launches that only its replays make), and inside
``tally(stream)`` also those any thread makes on that stream (a captured
backward's, which autograd launches from a thread of its own).

Off, the default, a span is one shared null context: it reads no clock
and keeps nothing. Tracing is on after ``enable()`` (until ``disable()``),
and in a thread while ``torch.profiler`` records it; whether a span is on
is decided when it is entered, so a span open when the profiler stops
still closes and is kept. An on span keeps its name, start and end
(``time.perf_counter_ns``), its parent's id, its thread, its frame (a
span without a frame takes its parent's, so every span of a frame carries
that frame's index) and its tag, and enters
``record_function("dns.<name>")`` while the profiler records, so a
profiler trace shows the program's spans on the device's clock. The store
keeps at most ``MAX_SPANS`` spans and counts the rest in
``spans.dropped``. Counters are always on.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd.profiler import record_function

MAX_SPANS = 200_000

_profiling = torch._C._autograd._profiler_enabled
_on = False
_spans: List["Span"] = []
_counters: Dict[str, float] = {}
_stream_tallies: Dict[int, Dict[str, float]] = {}  # a CUDA stream's id: its tally's dict
_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]  # the enclosing span's id in the same thread
    thread: int
    frame: Optional[int]
    tag: Optional[str] = None


_NULL = contextlib.nullcontext()


class _Open:
    """An entered span; kept in the store when it exits."""

    __slots__ = ("name", "frame", "tag", "id", "parent", "start", "range")

    def __init__(self, name: str, frame: Optional[int], tag: Optional[str]):
        self.name, self.frame, self.tag = name, frame, tag

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        if self.frame is None and top is not None:
            self.frame = top.frame
        self.range = record_function(f"dns.{self.name}") if _profiling() else None
        stack.append(self)
        if self.range is not None:
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        if len(_spans) < MAX_SPANS:
            _spans.append(Span(self.id, self.name, self.start, end, self.parent,
                               threading.get_ident(), self.frame, self.tag))
        else:
            count("spans.dropped")
        return False


def span(name: str, frame: Optional[int] = None, tag: Optional[str] = None):
    """A span named ``name`` over the ``with`` block; ``frame``: the frame
    index it belongs to (default: its parent's); ``tag``: what the work
    belongs to where its name alone does not say."""
    if not (_on or _profiling()):
        return _NULL
    return _Open(name, frame, tag)


def within(name: str) -> bool:
    """Is a span named ``name`` open in this thread? (False while tracing
    is off: no span is open then.)"""
    return any(s.name == name for s in getattr(_local, "stack", ()))


def _stream_key() -> int:
    """The id of the CUDA stream this thread launches on."""
    return torch.cuda.current_stream().cuda_stream


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` (from any thread), or to the
    thread's innermost ``tally``, or to the ``tally`` of the CUDA stream the
    thread launches on."""
    held = getattr(_local, "tally", None)
    if held is None and _stream_tallies:
        held = _stream_tallies.get(_stream_key())
    with _lock:
        into = _counters if held is None else held
        into[name] = into.get(name, 0) + n


@contextlib.contextmanager
def tally(stream=None):
    """Hold back the counts this thread makes inside the block: they add to
    the yielded dict, not to the counters. Given a CUDA ``stream``, so do the
    counts any other thread makes on that stream meanwhile: autograd runs a
    CUDA backward in a thread of its own, on the stream of its forward."""
    outer = getattr(_local, "tally", None)
    _local.tally = held = {}
    key = None if stream is None else stream.cuda_stream
    if key is not None:
        with _lock:
            _stream_tallies[key] = held
    try:
        yield held
    finally:
        _local.tally = outer
        if key is not None:
            with _lock:
                del _stream_tallies[key]


def spans() -> List[Span]:
    """The spans kept so far, in the order they closed."""
    return list(_spans)


def counters() -> Dict[str, float]:
    """A copy of the counters."""
    with _lock:
        return dict(_counters)


def clear() -> None:
    """Forget every span and counter."""
    with _lock:
        _spans.clear()
        _counters.clear()


def enable() -> None:
    """Turn tracing on in every thread, profiler or not."""
    global _on
    _on = True


def disable() -> None:
    """Turn it off again (a profiler session still turns it on)."""
    global _on
    _on = False
