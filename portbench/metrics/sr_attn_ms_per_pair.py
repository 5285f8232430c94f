"""Device ms of the MatchFormer matcher's attention cores per pair over
the traced stretch: every SRAttention call's K/V pooling, q/k/v
projections, chunked logits, softmax and values, and output projection,
both frames, every stage (models/matchformer.py). The program's own
`matcher/sr_attention` span over its `engine/pairs` counter
(`portbench/spans.py`)."""

from portbench.spans import span_ms_per_pair

UNIT = "ms/pair"
LAYER = "SR attention"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    return span_ms_per_pair("matcher/sr_attention")
