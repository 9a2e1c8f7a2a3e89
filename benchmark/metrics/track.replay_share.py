"""track.replay_share: the share of the program's tracked solves (its
always-on counter ``track.solves``, one a ``Tracker.track`` call) that
replayed the tracker's captured CUDA graph (``track.graph.replays``), over
the whole run, in %. A program without those counters gives nothing."""

from benchmark import program_spans


def read(ctx):
    got = program_spans.recorded()
    solves = got[1].get("track.solves") if got is not None else None
    if not solves:
        return None
    return 100.0 * got[1].get("track.graph.replays", 0) / solves
