"""Device ms of the MatchFormer matcher's encoder per pair over the
traced stretch: its three stages, from the first patch embed through the
last block, both frames (models/matchformer.py). The program's own
`matcher/encoder` span over its `engine/pairs` counter
(`portbench/spans.py`)."""

from portbench.spans import span_ms_per_pair

UNIT = "ms/pair"
LAYER = "MatchFormer encoder"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    return span_ms_per_pair("matcher/encoder")
