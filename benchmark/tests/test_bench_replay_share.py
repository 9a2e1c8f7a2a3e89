"""The reader of ``track.replay_share`` on canned program counters."""

import pytest

from benchmark import program_spans
from benchmark.run import load_reader


@pytest.mark.parametrize("recorded,share", [
    (([], {"track.solves": 46, "track.graph.replays": 46, "track.graph.captures": 1}), 100.0),
    (([], {"track.solves": 4, "track.graph.replays": 3}), 75.0),
    (([], {"track.solves": 5}), 0.0),  # every solve uncaptured
    (([], {"bootstrap.seconds": 31.5}), None),  # a program that counts no solve
    (None, None),  # a program without the spans module
])
def test_replay_share_reads_the_program_s_counters(monkeypatch, recorded, share):
    monkeypatch.setattr(program_spans, "recorded", lambda: recorded)
    assert load_reader("track.replay_share")({}) == share
