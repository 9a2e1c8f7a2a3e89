"""driver.other_share: the share of the window's wall outside the
benchmark's spans of loads, tracked frames and keysteps: the driver's own
host work (frame upload, keyframe insertion, logging, the closing
checkpoint)."""


def read(ctx):
    inside = sum(b - a for name, a, b, _ in ctx["spans"] if name in ("load", "track", "keystep"))
    wall = ctx["host_wall"]
    return 100.0 * (wall - inside) / wall if wall > 0 else None
