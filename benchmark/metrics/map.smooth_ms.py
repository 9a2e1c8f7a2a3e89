"""map.smooth_ms: the device time of the TV term per mapping iteration of
the traced period, in ms: the operations launched inside the program's
``map.smooth`` spans (the sub-grid's points, its encode and coarse MLP
forward, the TV loss) and inside the ``encode_bwd`` spans tagged
``map.smooth`` (its table gradient), aligned on the trace's clock by
``benchmark/map_spans.py``, over the program's ``map.iter`` spans. The TV
MLP's backward runs in neither span and is outside it."""

from benchmark import map_spans


def read(ctx):
    spans = map_spans.aligned(ctx)
    if spans is None:
        return None
    smooth = map_spans.named(spans, "map.smooth")
    iters = len(map_spans.named(spans, "map.iter"))
    if not smooth or not iters:
        return None
    bwd = map_spans.named(spans, "encode_bwd", tag="map.smooth")
    ops = map_spans.ops_launched_in(ctx["trace"], [(a, b) for _, a, b in smooth + bwd])
    return sum(op[2] for op in ops) / 1e3 / iters if ops else None  # us -> ms
