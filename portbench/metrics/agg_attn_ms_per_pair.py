"""Device ms of EfficientLoFTR's aggregated-attention modules per pair
over the traced stretch: each module's aggregation, projections, 2-D
RoPE, attention core, output projection, x4 upsampling, MLP and residual,
16 a pair (models/efficientloftr.py). The program's own
`matcher/aggregated_attention` span over its `engine/pairs` counter
(`portbench/spans.py`)."""

from portbench.spans import span_ms_per_pair

UNIT = "ms/pair"
LAYER = "aggregated attention"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    return span_ms_per_pair("matcher/aggregated_attention")
