"""data.load_ms: the mean host time of one call of the dataset's
``__getitem__`` (the port's Replica or ScanNet loader reading a frame's
files) in the window, from the benchmark's ``load`` spans."""


def read(ctx):
    t = [b - a for name, a, b, _ in ctx["spans"] if name == "load"]
    return 1e3 * sum(t) / len(t) if t else None
