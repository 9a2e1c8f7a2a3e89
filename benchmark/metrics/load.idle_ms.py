"""load.idle_ms: the device's idle time per traced frame while the host is
in the program's ``load`` spans (a frame's files read by the dataset), in
ms: ``program_spans.idle_split`` over the traced frames."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, "load")
