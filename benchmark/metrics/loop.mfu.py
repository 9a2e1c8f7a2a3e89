"""loop.mfu: the model FLOPs of all the loop's work in the measured stretch
(tracked frames by the iterations they ran, keysteps, decoder warm-ups)
over its wall, against the card's peak in the compute dtype, in percent: the
whole step's share, which bounds what any kernel's roofline can claim."""

from benchmark import counts


def read(ctx):
    cfg, C, H, W = ctx["cfg"], ctx["n_class"], ctx["H"], ctx["W"]
    flops = 0
    for e in ctx["events"]:
        kind = e.get("event")
        if kind == "track":
            flops += counts.track_flops(cfg, C, H, W, int(e["n_iters_run"]))
        elif kind == "map":
            flops += counts.keystep_flops(cfg, C, H, W)
        elif kind == "decoder_init":
            flops += counts.decoder_init_flops(cfg, C, int(e["iters"]))
    wall = ctx["host_wall"]
    return 100.0 * flops / wall / counts.peak_flops(cfg, ctx["peaks"]) if flops else None
