"""The program's own spans and counters (utils/profiler.py) of the traced
session, per pair, for the per-layer metrics' readers: None where the
program is not importable, records no such span or counter, or runs off
the card (a span without device time)."""


def _snapshot():
    try:
        from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    except ImportError:
        return None
    return snapshot()


def span_device_ms(name: str):
    """Device ms of span `name`, or None."""
    snap = _snapshot()
    if snap is None:
        return None
    return snap["spans"].get(name, {}).get("device_ms")


def span_ms_per_pair(name: str):
    """Device ms of span `name` over the counter `engine/pairs`."""
    snap = _snapshot()
    if snap is None:
        return None
    ms = snap["spans"].get(name, {}).get("device_ms")
    pairs = snap["counters"].get("engine/pairs")
    if ms is None or not pairs:
        return None
    return ms / pairs


def counter_per_pair(name: str):
    """Counter `name` over the counter `engine/pairs`."""
    snap = _snapshot()
    if snap is None:
        return None
    counters = snap["counters"]
    if not counters.get("engine/pairs") or name not in counters:
        return None
    return counters[name] / counters["engine/pairs"]
