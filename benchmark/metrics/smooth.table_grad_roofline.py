"""smooth.table_grad_roofline: the least time of the TV term's encode
backward calls in the traced period (those of (smooth_pts - 1)^3 points:
the table gradient's bytes bound, ``counts.encode_backward_bytes``, at the
card's HBM bandwidth) over the device time of the operations launched
inside the program's ``encode_bwd`` spans tagged ``map.smooth`` (aligned
by ``benchmark/map_spans.py``), in percent."""

from benchmark import counts, map_counts, map_spans


def read(ctx):
    spans = map_spans.aligned(ctx)
    n = map_counts.tv_points(ctx["cfg"])
    calls = [c for c in ctx["encode_bwd"] if c[0] == n]
    if spans is None or not calls:
        return None
    bwd = [(a, b) for _, a, b in map_spans.named(spans, "encode_bwd", tag="map.smooth")]
    busy = map_spans.device_s(ctx["trace"], bwd)
    nbytes = sum(counts.encode_backward_bytes(ctx["grid_spec"], k, pos) for k, pos in calls)
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / busy if busy > 0 else None
