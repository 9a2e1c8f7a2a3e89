"""driver.idle_ms: the device's idle time per traced frame while the host
is in none of the program's ``load``, ``track`` and ``keystep`` spans (the
driver's own work: upload, keyframes, logs), in ms:
``program_spans.idle_split`` over the traced frames. The four idle
metrics add up to the idle time between the traced period's first and
last device operation, per traced frame."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, "driver")
