"""Share of the ASpan matcher's window queries whose (2r+1)^2 window the
grid's edge clipped, so that it attends repeated cells (models/aspan.py):
100 x the program's own `aspan/window_clamped` counter over
`aspan/window_queries` (queries x rounds x directions; utils/profiler.py)
of the traced session; nothing where the program counts no windows."""

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
    if not queries:
        return None
    return 100.0 * counters["aspan/window_clamped"] / queries
