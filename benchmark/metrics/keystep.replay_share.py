"""keystep.replay_share: the share of the program's mapping iterations (its
always-on counter ``map.iters``, one an iteration of a keystep's or the
bootstrap's mapping call) that replayed the keystep's captured CUDA graphs
(``map.graph.replays``), over the whole run, in %. A program without those
counters gives nothing."""

from benchmark import program_spans


def read(ctx):
    got = program_spans.recorded()
    iters = got[1].get("map.iters") if got is not None else None
    if not iters:
        return None
    return 100.0 * got[1].get("map.graph.replays", 0) / iters
