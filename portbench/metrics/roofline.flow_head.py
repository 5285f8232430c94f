"""The ASpan flow heads' share of their roofline: the least time of the
traced pairs' L x L similarity and expectation products at the bf16 peak,
or of reading both fp32 64-d projections once and writing the (L, 2)
flow once at the HBM peak, whichever is longer (roofline_aspan.py), over
the device time of the program's own `matcher/flow_head` span
(utils/profiler.py) in the traced stretch; nothing where the program
records no such span or runs off the card."""

from portbench.roofline import roofline_share

UNIT = "%"
LAYER = "flow head"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    ms = snapshot()["spans"].get("matcher/flow_head", {}).get("device_ms")
    flops = ctx.counters.get("traced_flow_flops")
    if not ms or not flops:
        return None
    return roofline_share(flops, ctx.counters["traced_flow_bytes"],
                          ms * 1e-3)
