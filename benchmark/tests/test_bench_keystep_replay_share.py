"""The reader of ``keystep.replay_share`` on canned program counters."""

import pytest

from benchmark import program_spans
from benchmark.run import load_reader


@pytest.mark.parametrize("recorded,share", [
    (([], {"map.iters": 1200, "map.graph.replays": 1200, "map.graph.captures": 2}), 100.0),
    (([], {"map.iters": 600, "map.graph.replays": 500}), 100.0 * 500 / 600),
    (([], {"map.iters": 700}), 0.0),  # every iteration uncaptured
    (([], {"track.solves": 46}), None),  # a program that counts no mapping iteration
    (None, None),  # a program without the spans module
])
def test_keystep_replay_share_reads_the_program_s_counters(monkeypatch, recorded, share):
    monkeypatch.setattr(program_spans, "recorded", lambda: recorded)
    assert load_reader("keystep.replay_share")({}) == share
