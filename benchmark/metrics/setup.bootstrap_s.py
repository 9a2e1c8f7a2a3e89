"""setup.bootstrap_s: the seconds of the program's bootstrap (frame 0's
mapping of ``n_iters_first`` iterations, ``DNSSLAM._bootstrap``), from its
always-on counter ``bootstrap.seconds``: it runs in set-up, before the
profiler starts."""

from benchmark import program_spans


def read(ctx):
    got = program_spans.recorded()
    return got[1].get("bootstrap.seconds") if got is not None else None
