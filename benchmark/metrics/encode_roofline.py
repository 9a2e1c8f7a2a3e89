"""encode_roofline: the least time of the hash-grid encode's forward calls
in the traced period (their bytes bound, ``counts.encode_bytes``, at the
card's HBM bandwidth) over the device time of the operations launched
inside the benchmark's ``encode`` ranges around the port's ``hash_encode``,
in percent. The tracker's forward-mode calls (``encode_jvp``) are not in
it."""

from benchmark import counts
from benchmark.trace import ops_in


def read(ctx):
    if ctx["trace"] is None or not ctx["encode_fwd"]:
        return None
    busy = sum(op[2] for op in ops_in(ctx["trace"], "encode")) / 1e6
    nbytes = sum(counts.encode_bytes(ctx["grid_spec"], n, res, u)
                 for n, res, u in ctx["encode_fwd"])
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / busy if busy > 0 else None
