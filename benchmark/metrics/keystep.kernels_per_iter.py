"""keystep.kernels_per_iter: the device operations launched inside the
benchmark's ``keystep`` ranges of the traced period (window building,
overlap scoring and any decoder warm-up included), per mapping iteration."""

from benchmark.trace import ops_in


def read(ctx):
    n = ctx["traced_keysteps"] * (int(ctx["cfg"]["mapping"]["n_iters"]) // 2 * 2)
    if ctx["trace"] is None or n == 0:
        return None
    ops = ops_in(ctx["trace"], "keystep")
    return len(ops) / n if ops else None
