"""Device ms of EfficientLoFTR's RepVGG backbone per pair over the traced
stretch: the frames a call stages through the backbone, once per view
(models/efficientloftr.py). The program's own `matcher/repvgg` span over
its `engine/pairs` counter (`portbench/spans.py`)."""

from portbench.spans import span_ms_per_pair

UNIT = "ms/pair"
LAYER = "RepVGG"
SOURCE = "program_span"
MOVES = "pairs_per_s"


def read(ctx):
    return span_ms_per_pair("matcher/repvgg")
