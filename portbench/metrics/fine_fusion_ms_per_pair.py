"""Device ms of EfficientLoFTR's fine fusion per pair over the traced
stretch: the pyramid from the coarse features and the backbone's 1/4 and
1/2 maps to the full-resolution map of both frames, and the gather of
the windows at the top-K slots (models/efficientloftr.py). The program's
own `matcher/fine_fusion` span over its `engine/pairs` counter
(`portbench/spans.py`)."""

from portbench.spans import span_ms_per_pair

UNIT = "ms/pair"
LAYER = "fine fusion"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    return span_ms_per_pair("matcher/fine_fusion")
