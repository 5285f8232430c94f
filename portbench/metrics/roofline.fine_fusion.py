"""EfficientLoFTR's fine fusion's share of its roofline: the least time
of the traced pairs' fusion conv products at the bf16 peak, or of reading
its three input maps once and writing the full-resolution map once in
fp32 at the HBM peak, whichever is longer (roofline_efficientloftr.py),
over the device time of the program's own `matcher/fine_fusion` span in
the traced stretch (`portbench/spans.py`); nothing where the program
records no such span or runs off the card."""

from portbench.roofline import roofline_share
from portbench.spans import span_device_ms

UNIT = "%"
LAYER = "fine fusion"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    ms = span_device_ms("matcher/fine_fusion")
    flops = ctx.counters.get("traced_fusion_flops")
    if not ms or not flops:
        return None
    return roofline_share(flops, ctx.counters["traced_fusion_bytes"],
                          ms * 1e-3)
