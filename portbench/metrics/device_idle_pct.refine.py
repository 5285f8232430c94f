"""Share of the traced stretch of the refinement window in which no
kernel, memcpy or memset ran on the card (1 - their union over the
stretch)."""

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "tracks_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return t.idle_pct
