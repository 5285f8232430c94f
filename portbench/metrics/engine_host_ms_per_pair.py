"""Host ms of the pair-matching engine's own work per pair over the
traced stretch: staging a step's frames and copying them to the card,
launching each card's block, and unpacking the results (rescale, 4 px
rounding, the result dicts; match/engine.py), not the wait for the card.
The program's own `engine/stage`, `engine/launch` and `engine/unpack`
spans (utils/profiler.py) over its `engine/pairs` counter, both of the
traced session; nothing where the program records no such spans."""

UNIT = "ms/pair"
LAYER = "engine"
SOURCE = "program_span"
MOVES = "pairs_per_s"
SPANS = ("engine/stage", "engine/launch", "engine/unpack")


def read(ctx):
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    snap = snapshot()
    pairs = snap["counters"].get("engine/pairs")
    if not pairs or not all(n in snap["spans"] for n in SPANS):
        return None
    return sum(snap["spans"][n]["host_ms"] for n in SPANS) / pairs
