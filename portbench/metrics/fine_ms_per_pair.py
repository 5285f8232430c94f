"""Device ms of the matcher's fine stage per pair over the traced
stretch: the 5x5 window gather, the fine transformer and the soft-argmax
(models/loftr.py, ops/dsnt.py). The program's own `matcher/fine` span
(utils/profiler.py) over its `engine/pairs` counter, both of the traced
session; nothing where the program records no such span or runs off the
card."""

UNIT = "ms/pair"
LAYER = "fine stage"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    snap = snapshot()
    ms = snap["spans"].get("matcher/fine", {}).get("device_ms")
    pairs = snap["counters"].get("engine/pairs")
    if ms is None or not pairs:
        return None
    return ms / pairs
