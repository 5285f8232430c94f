"""Device ms of the refiner's S2DNet backbone (models/s2dnet.py) per
chunk over the window: CUDA events around each call of the module."""

UNIT = "ms/chunk"
LAYER = "S2DNet"
SOURCE = "program_span"
MOVES = "tracks_per_s"


def read(ctx):
    ms = ctx.hook_ms.get("s2dnet")
    chunks = ctx.counters.get("chunks", 0)
    if ms is None or not chunks:
        return None
    return ms / chunks
