"""Share of the pair sides that the pair-matching engine read from its
view store without running the per-image stage for them
(match/engine.py): 100 x (1 - frames through the per-image stage, padding
included, over the pair sides read from the store). The program's own
`engine/views` and `engine/view_uses` counters (utils/profiler.py) of the
traced session; nothing where the program keeps no view store."""

UNIT = "%"
LAYER = "engine"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(ctx):
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    counters = snapshot()["counters"]
    uses = counters.get("engine/view_uses")
    if not uses or "engine/views" not in counters:
        return None
    return 100.0 * (1.0 - counters["engine/views"] / uses)
