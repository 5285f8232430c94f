"""Share of EfficientLoFTR's aggregated queries whose attention the
hand-written kernel of ops/sr_attention.py computed (csrc/sr_attention.cu,
one pass over the pooled keys without writing logits): 100 x the
program's own `eloftr/attn_fused` counter over `eloftr/attn_queries`
(aggregated queries x frames a module call; utils/profiler.py) of the
traced session; nothing where the program counts no such queries."""

UNIT = "%"
LAYER = "aggregated attention"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(ctx):
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    counters = snapshot()["counters"]
    queries = counters.get("eloftr/attn_queries")
    if not queries or "eloftr/attn_fused" not in counters:
        return None
    return 100.0 * counters["eloftr/attn_fused"] / queries
