"""Share of the node slots the multiview refiner computes that hold a
live node (models/multiview_matcher.py): every chunk runs T x V slots,
whatever its tracks' lengths. The program's own `refiner/live_slots` and
`refiner/slots` counters (utils/profiler.py) of the traced session;
nothing where the program counts no slots."""

UNIT = "%"
LAYER = "refiner step"
SOURCE = "program_counter"
MOVES = "tracks_per_s"


def read(ctx):
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    counters = snapshot()["counters"]
    slots = counters.get("refiner/slots")
    if not slots:
        return None
    return 100.0 * counters["refiner/live_slots"] / slots
