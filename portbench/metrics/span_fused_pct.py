"""Share of the ASpan matcher's window queries whose span attention the
hand-written kernel computed, reading each 5 x 5 window's rows in place
without gathered keys and values (ops/span_attention.py,
csrc/span_attention.cu): 100 x the program's own `aspan/span_fused`
counter over `aspan/window_queries` (queries x rounds x directions;
utils/profiler.py) of the traced session; nothing where the program
counts no kernel queries (as one that does not have the kernel)."""

UNIT = "%"
LAYER = "span attention"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(ctx):
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    counters = snapshot()["counters"]
    queries = counters.get("aspan/window_queries")
    if not queries or "aspan/span_fused" not in counters:
        return None
    return 100.0 * counters["aspan/span_fused"] / queries
