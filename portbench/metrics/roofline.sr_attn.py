"""The MatchFormer attention cores' share of their roofline: the least
time of the traced pairs' QK and AV products (4 N M C a layer and frame)
at the bf16 peak, or of reading q and the pooled k and v once and
writing the output once in fp32 at the HBM peak, whichever is longer
(roofline_matchformer.py), over the device time of the program's own
`matcher/sr_attention` span in the traced stretch (`portbench/spans.py`);
nothing where the program records no such span or runs off the card."""

from portbench.roofline import roofline_share
from portbench.spans import span_device_ms

UNIT = "%"
LAYER = "SR attention"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    ms = span_device_ms("matcher/sr_attention")
    flops = ctx.counters.get("traced_sr_attn_flops")
    if not ms or not flops:
        return None
    return roofline_share(flops, ctx.counters["traced_sr_attn_bytes"],
                          ms * 1e-3)
