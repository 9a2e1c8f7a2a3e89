"""map.adam_roofline: the least time of the map optimizer's updates in the
traced period (``map_counts.adam_bytes`` each: every map parameter's
value, gradient and two moments read and value and moments written, at the
card's HBM bandwidth) over the device time of the operations launched
inside the program's ``map.adam`` spans (aligned by
``benchmark/map_spans.py``), in percent."""

from benchmark import map_counts, map_spans


def read(ctx):
    spans = map_spans.aligned(ctx)
    if spans is None:
        return None
    adam = map_spans.named(spans, "map.adam")
    busy = map_spans.device_s(ctx["trace"], [(a, b) for _, a, b in adam])
    if busy <= 0:
        return None
    nbytes = len(adam) * map_counts.adam_bytes(ctx["cfg"], ctx["grid_spec"], ctx["n_class"])
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / busy
