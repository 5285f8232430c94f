"""Device ms of the matcher's coarse transformer (models/transformer.py,
ops/attention.py) per pair over the window: CUDA events around each call
of the module."""

UNIT = "ms/pair"
LAYER = "coarse transformer"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    ms = ctx.hook_ms.get("coarse_transformer")
    pairs = ctx.counters.get("pairs", 0)
    if ms is None or not pairs:
        return None
    return ms / pairs
