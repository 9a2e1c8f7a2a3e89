"""track.kernels_per_frame: the device operations launched inside the
benchmark's ``track`` ranges of the traced period, per tracked frame."""

from benchmark.trace import ops_in


def read(ctx):
    n = ctx["traced_frames"]
    if ctx["trace"] is None or n == 0:
        return None
    ops = ops_in(ctx["trace"], "track")
    return len(ops) / n if ops else None
