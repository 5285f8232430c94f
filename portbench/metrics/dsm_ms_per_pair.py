"""Device ms of the matcher's dual-softmax per pair over the traced
stretch: the dense confidence and its top-K extraction, or the CUDA
passes (models/loftr.py, ops/dual_softmax.py, ops/fused_dsm.py). The
program's own `matcher/dual_softmax` span (utils/profiler.py) over its
`engine/pairs` counter, both of the traced session; nothing where the
program records no such span or runs off the card."""

UNIT = "ms/pair"
LAYER = "dual-softmax"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    snap = snapshot()
    ms = snap["spans"].get("matcher/dual_softmax", {}).get("device_ms")
    pairs = snap["counters"].get("engine/pairs")
    if ms is None or not pairs:
        return None
    return ms / pairs
