"""smooth.encode_roofline: the least time of the TV term's hash-grid encode
calls in the traced period (the forward calls of (smooth_pts - 1)^3
points: their bytes bound, ``counts.encode_bytes``, at the card's HBM
bandwidth) over the device time of the operations launched inside the
program's ``encode`` spans that a ``map.smooth`` span holds (aligned by
``benchmark/map_spans.py``), in percent."""

from benchmark import counts, map_counts, map_spans


def read(ctx):
    spans = map_spans.aligned(ctx)
    n = map_counts.tv_points(ctx["cfg"])
    calls = [c for c in ctx["encode_fwd"] if c[0] == n]
    if spans is None or not calls:
        return None
    smooth = {s.id for s, _, _ in map_spans.named(spans, "map.smooth")}
    enc = [(a, b) for s, a, b in map_spans.named(spans, "encode") if s.parent in smooth]
    busy = map_spans.device_s(ctx["trace"], enc)
    nbytes = sum(counts.encode_bytes(ctx["grid_spec"], k, res, u) for k, res, u in calls)
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / busy if busy > 0 else None
