"""pos_grad_roofline: the least time of the encode's position gradients in
the traced period (the position part of ``counts.encode_backward_bytes``:
its value with the point gradient less its value without, over the
backward calls that took one) at the card's HBM bandwidth, over the device
time of the operations launched inside the program's ``encode_bwd.pos``
spans (aligned by ``benchmark/map_spans.py``), in percent. A program that
opens no such span reads None."""

from benchmark import counts, map_spans


def read(ctx):
    spans = map_spans.aligned(ctx)
    calls = [n for n, pos in ctx["encode_bwd"] if pos]
    if spans is None or not calls:
        return None
    pos = [(a, b) for _, a, b in map_spans.named(spans, "encode_bwd.pos")]
    busy = map_spans.device_s(ctx["trace"], pos)
    spec = ctx["grid_spec"]
    nbytes = sum(counts.encode_backward_bytes(spec, n, True)
                 - counts.encode_backward_bytes(spec, n, False) for n in calls)
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / busy if busy > 0 else None
