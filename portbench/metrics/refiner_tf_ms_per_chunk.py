"""Device ms of the refiner's transformer (models/transformer.py,
ops/attention.py) per chunk over the window: CUDA events around each call
of the module."""

UNIT = "ms/chunk"
LAYER = "refiner transformer"
SOURCE = "program_span"
MOVES = "tracks_per_s"


def read(ctx):
    ms = ctx.hook_ms.get("transformer")
    chunks = ctx.counters.get("chunks", 0)
    if ms is None or not chunks:
        return None
    return ms / chunks
