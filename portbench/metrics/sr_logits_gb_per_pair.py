"""GB of fp32 attention logits that the MatchFormer matcher's query
chunks write per pair over the traced stretch (2B x heads x N x M x 4
bytes an SRAttention call, from shapes; models/matchformer.py): the
program's own `matchformer/logit_bytes` counter over its `engine/pairs`
counter (`portbench/spans.py`); nothing where the program counts no
logits. An attention that never writes them reads 0."""

from portbench.spans import counter_per_pair

UNIT = "GB/pair"
LAYER = "SR attention"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(ctx):
    per_pair = counter_per_pair("matchformer/logit_bytes")
    return None if per_pair is None else per_pair * 1e-9
