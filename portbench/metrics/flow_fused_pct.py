"""Share of the ASpan matcher's flow-head queries whose expectation the
hand-written kernel computed without writing the (B, L, L) similarity
(ops/flow_expectation.py, csrc/flow_head.cu): 100 x the program's own
`aspan/flow_fused` counter over `aspan/flow_queries` (queries x rounds x
directions; utils/profiler.py) of the traced session; nothing where the
program counts no flow-head queries."""

UNIT = "%"
LAYER = "flow head"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(ctx):
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    counters = snapshot()["counters"]
    queries = counters.get("aspan/flow_queries")
    if not queries or "aspan/flow_fused" not in counters:
        return None
    return 100.0 * counters["aspan/flow_fused"] / queries
