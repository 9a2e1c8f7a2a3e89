"""keystep.mfu: the model FLOPs of the keysteps (``counts.keystep_flops``)
over the ``map`` events' ``seconds``, against the card's peak in the
configuration's compute dtype, in percent."""

from benchmark import counts


def read(ctx):
    maps = [float(e["seconds"]) for e in ctx["events"] if e.get("event") == "map"]
    if not maps:
        return None
    flops = counts.keystep_flops(ctx["cfg"], ctx["n_class"], ctx["H"], ctx["W"])
    return 100.0 * flops * len(maps) / sum(maps) / counts.peak_flops(ctx["cfg"], ctx["peaks"])
