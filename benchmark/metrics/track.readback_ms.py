"""track.readback_ms: the mean host wait in the program's
``track.readback`` spans of the traced period (the tracked pose's one copy
to the host, which waits for the device to finish the frame's work), in
ms: how far the device trails the tracker's launches."""

from benchmark import program_spans


def read(ctx):
    got = program_spans.recorded()
    if got is None:
        return None
    t = [s.end_ns - s.start_ns for s in got[0] if s.name == "track.readback"]
    return sum(t) / len(t) / 1e6 if t else None
