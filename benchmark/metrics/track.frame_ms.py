"""track.frame_ms: the mean of the ``track`` events' ``seconds`` in the
port's metrics.jsonl (host wall of a tracked frame, ending in a host read
of its pose)."""


def read(ctx):
    t = [float(e["seconds"]) for e in ctx["events"] if e.get("event") == "track"]
    return 1e3 * sum(t) / len(t) if t else None
