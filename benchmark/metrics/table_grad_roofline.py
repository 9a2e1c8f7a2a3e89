"""table_grad_roofline: the least time of the encode's backward calls in
the traced period (the table gradient's bytes bound and, where the points
take a gradient, the position gradient's: ``counts.encode_backward_bytes``)
over the device time of the operations launched inside the benchmark's
``encode_bwd`` ranges, in percent."""

from benchmark import counts
from benchmark.trace import ops_in


def read(ctx):
    if ctx["trace"] is None or not ctx["encode_bwd"]:
        return None
    busy = sum(op[2] for op in ops_in(ctx["trace"], "encode_bwd")) / 1e6
    nbytes = sum(counts.encode_backward_bytes(ctx["grid_spec"], n, pos)
                 for n, pos in ctx["encode_bwd"])
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / busy if busy > 0 else None
