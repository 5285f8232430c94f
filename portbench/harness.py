"""One run of one cell: find its files by name, set up the driver, measure
the window, read the per-layer metrics, decide `correct`, print the
result.

Everything a cell needs sits in files of its own, found by name:
  workloads/<cell>.json   the configuration it runs, its traffic, its
                          chips, the driver kind and the limits of its
                          comparison;
  configs/<config>.json   the model's sizes, weights, precision, source;
  drivers/<kind>.py       what the window drives (a `Driver` class);
  metrics/<metric>.py     a per-layer metric: UNIT, LAYER, MOVES, SOURCE
                          and `read(ctx)`, which returns None where it
                          finds nothing to read.
A traced run reports every metric whose MOVES is one of the driver's
end-to-end metrics and whose reader returns a number.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "detectorfreesfm_tpu")
TRACE_MIN_S = 4.0   # the traced stretch: whole units from the second on


class Refused(SystemExit):
    """A run that must print no result: the message goes to stderr."""

    def __init__(self, msg):
        super().__init__(msg)


def set_cache_dirs(root: Path = ROOT) -> None:
    """Kernel and build caches at fixed paths inside the checkout, so
    that only the first run in a checkout builds (the port's nvcc library
    goes to build/torch_kernels/ by itself)."""
    base = root / "build" / "portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ.setdefault(var, str(base / sub))


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str, here: Path = HERE) -> dict:
    path = here / kind / f"{name}.json"
    if not path.is_file():
        raise Refused(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_driver(kind: str, here: Path = HERE):
    path = here / "drivers" / f"{kind}.py"
    if not path.is_file():
        raise Refused(f"no driver named {kind!r} ({path})")
    return _load_module(path, f"portbench_driver_{kind}").Driver


def load_metrics(here: Path = HERE) -> dict:
    """{metric name: module} of every metrics/<name>.py."""
    out = {}
    for i, path in enumerate(sorted((here / "metrics").glob("*.py"))):
        out[path.name[:-3]] = _load_module(path, f"portbench_metric_{i}")
    return out


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of BANNED, whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def card_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip() or p.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e!r})"


def measure(driver, seconds, trace, tmp):
    """Units of work until `seconds` have passed (at least one; two when
    traced); a traced run profiles whole units from the second until
    TRACE_MIN_S have passed. Returns (work done, span s, seconds of each
    unit, trace path, the traced units' counters)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof, traced_s, traced_flops, path = None, 0.0, {}, None
    done, units, unit_s = 0, 0, []
    t0 = time.perf_counter()
    while True:
        tracing = trace and units >= 1 and (prof is None or
                                            traced_s < TRACE_MIN_S)
        if tracing and prof is None:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        u0 = time.perf_counter()
        with record_function("portbench/unit"):
            rec = driver.run_unit(units)
        done += rec["done"]
        units += 1
        unit_s.append(time.perf_counter() - u0)
        if tracing:
            traced_s += unit_s[-1]
            for k, v in rec.items():
                k = f"traced_{k}"
                traced_flops[k] = traced_flops.get(k, 0) + v
            if traced_s >= TRACE_MIN_S:
                prof.stop()
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and units >= (2 if trace else 1) and \
                (prof is None or traced_s >= TRACE_MIN_S):
            break
    if prof is not None:
        if traced_s < TRACE_MIN_S:
            prof.stop()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
    return done, elapsed, unit_s, path, traced_flops


def run(workload: str, seed: int, seconds: float, trace: bool,
        device=None, t_start=None, here: Path = HERE, out=None,
        overrides: dict = None) -> dict:
    """One run; prints the info and result lines and returns the result.
    `device` None means the card, which must be present (tests pass the
    CPU); `overrides` replaces workload keys (tests only)."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = sys.stdout if out is None else out
    cell = load_json("workloads", workload, here)
    cell.update(overrides or {})
    config = load_json("configs", cell["config"], here)
    Driver = load_driver(cell["driver"], here)
    metrics = load_metrics(here) if trace else {}

    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise Refused("no CUDA card: torch.cuda.is_available() is "
                          "false")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"the cell needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.set_num_threads(min(4, torch.get_num_threads()))

    driver = Driver(cell, config, seed, device, ROOT)
    driver.setup(trace)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    with tempfile.TemporaryDirectory() as tmp:
        done, span, units, path, traced = measure(driver, seconds, trace,
                                                  tmp)
        found = banned_modules()
        if found:
            raise Refused("modules of JAX or the JAX package are loaded: " +
                          ", ".join(found))
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        summary = None
        if path is not None:
            from . import trace as tr
            summary = tr.read(path)

    info = driver.info()
    dev = dict(card_info(device), memory_peak_bytes=int(peak))
    e2e_name, e2e_unit = driver.END_TO_END
    result = {"correct": None, "attempted": done, "failed": 0,
              "metrics": {}, "device": dev}
    if trace:
        ctx = types.SimpleNamespace(
            trace=summary, counters=dict(driver.counters(), **traced),
            hook_ms=driver.hook_ms(), cell=cell, config=config)
        for name, mod in sorted(metrics.items()):
            if mod.MOVES != e2e_name:
                continue
            value = mod.read(ctx)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": mod.UNIT}
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {
            "device_ops": [[k[:120], s] for k, s in summary.top_ops(10)],
            "idle_gaps": [[k[:120], s] for k, s in summary.gaps[:10]]}
    else:
        result["metrics"] = {
            e2e_name: {"value": done / span, "unit": e2e_unit},
            "setup_s": {"value": setup_s, "unit": "s"}}

    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check()
    failed = [c for c in checks if not c["value"] <= c["limit"]]
    result["correct"] = not failed
    result["failed"] = driver.failed_answers()
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    print(json.dumps(dict(info, card=power_limit() if cuda else "cpu",
                          memory_peak_bytes=int(peak), unit_s=units,
                          window_s=span)), file=out, flush=True)
    print(json.dumps(result), file=out, flush=True)
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return result
