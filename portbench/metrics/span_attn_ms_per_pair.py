"""Device ms of the ASpan matcher's span attention per pair over the
traced stretch: both directions' window cells, gather, logits, softmax,
values, merge and feed-forward, every round (models/aspan.py). The
program's own `matcher/span_attention` span (utils/profiler.py) over its
`engine/pairs` counter, both of the traced session; nothing where the
program records no such span or runs off the card."""

UNIT = "ms/pair"
LAYER = "span attention"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    snap = snapshot()
    ms = snap["spans"].get("matcher/span_attention", {}).get("device_ms")
    pairs = snap["counters"].get("engine/pairs")
    if ms is None or not pairs:
        return None
    return ms / pairs
