"""device.idle_share: the share of the traced period in which no device
operation runs (the union of the operations' intervals on the trace), in
percent."""

from benchmark.trace import busy_intervals


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    busy = sum(b - a for a, b in busy_intervals(tr)) / 1e6
    return 100.0 * (1.0 - busy / tr["window_s"])
