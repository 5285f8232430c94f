"""Device ms of the matcher's ResNet-FPN backbone (models/backbone.py) per
pair over the window: CUDA events around each call of the module."""

UNIT = "ms/pair"
LAYER = "backbone"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    ms = ctx.hook_ms.get("backbone")
    pairs = ctx.counters.get("pairs", 0)
    if ms is None or not pairs:
        return None
    return ms / pairs
