"""map.loop_mfu: ``loop.mfu``'s arithmetic in a known-pose cell, the model
FLOPs of all the loop's work in the measured stretch (keysteps, decoder
warm-ups, and tracked frames where there are any) over its wall, against
the card's peak in the compute dtype, in percent: the whole step's share,
which bounds what any kernel's roofline in the cell can claim."""

from benchmark.run import load_reader

_loop_mfu = load_reader("loop.mfu")


def read(ctx):
    return _loop_mfu(ctx)
