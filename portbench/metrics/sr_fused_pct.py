"""Share of the MatchFormer matcher's SR attention queries whose attention
the hand-written kernel computed, in one pass over the pooled keys without
writing logits (ops/sr_attention.py, csrc/sr_attention.cu): 100 x the
program's own `matchformer/sr_fused` counter over `matchformer/sr_queries`
(2B x N an SRAttention call; utils/profiler.py) of the traced session;
nothing where the program counts no kernel queries (as one that does not
have the kernel)."""

UNIT = "%"
LAYER = "SR attention"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(ctx):
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    counters = snapshot()["counters"]
    queries = counters.get("matchformer/sr_queries")
    if not queries or "matchformer/sr_fused" not in counters:
        return None
    return 100.0 * counters["matchformer/sr_fused"] / queries
