"""The whole refiner step's share of the card's bf16 peak: the operations
the plain reference needs for the traced tracks' live nodes
(roofline.refiner_track) over the traced stretch."""

from portbench.roofline import PEAKS

UNIT = "%"
LAYER = "refiner step"
SOURCE = "device_trace"
MOVES = "tracks_per_s"


def read(ctx):
    t = ctx.trace
    flops = ctx.counters.get("traced_flops", 0)
    if t is None or t.busy_s <= 0 or not flops:
        return None
    return 100.0 * flops / t.window_s / PEAKS["bf16_flops_per_s"]
