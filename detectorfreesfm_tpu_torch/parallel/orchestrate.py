"""Host-level work distribution: chunkers + scene queue + progress.

Port of the JAX package's parallel/orchestrate.py. Scenes are distributed
over processes (one per card) and each process reconstructs its strided
share; data-parallel training sums its gradients over the processes and
starts them from process 0's weights (`all_reduce_sum`,
`broadcast_from_first`), where JAX's global mesh does both. The process index and count come from an initialised
torch.distributed group, as the training verbs' scene sharding does, and
are (0, 1) otherwise; tests pass them explicitly. Deterministic by
construction (no shuffled chunk indices).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, TypeVar

T = TypeVar("T")


def chunks(items: Sequence[T], n_per_chunk: int) -> List[List[T]]:
    """Fixed-size contiguous chunks (reference ray_utils.chunks:88)."""
    return [
        list(items[i : i + n_per_chunk])
        for i in range(0, len(items), n_per_chunk)
    ]


def chunks_balance(items: Sequence[T], n_chunks: int) -> List[List[T]]:
    """Round-robin split into n_chunks near-equal parts
    (reference chunks_balance:101); deterministic order."""
    out: List[List[T]] = [[] for _ in range(max(n_chunks, 1))]
    for i, it in enumerate(items):
        out[i % max(n_chunks, 1)].append(it)
    return out


def chunk_index(n: int, n_per_chunk: int) -> List[List[int]]:
    return chunks(list(range(n)), n_per_chunk)


def chunk_index_balance(n: int, n_chunks: int) -> List[List[int]]:
    return chunks_balance(list(range(n)), n_chunks)


def split_dict(d: Dict, n_chunks: int) -> List[Dict]:
    keys = sorted(d)
    return [
        {k: d[k] for k in part} for part in chunks_balance(keys, n_chunks)
    ]


def process_rank_count() -> Tuple[int, int]:
    """(index, count) of this process in an initialised torch.distributed
    group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _flat_collective(tensors, op):
    """Run op(flat) on the tensors' flattened concatenation, then copy the
    result back into them (in place); a no-op without a group."""
    if process_rank_count()[1] == 1 or not tensors:
        return tensors
    import torch

    flat = torch.cat([t.reshape(-1) for t in tensors])
    op(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return tensors


def all_reduce_sum(tensors):
    """Sum each tensor (one dtype, one device) over the processes of an
    initialised torch.distributed group, in place, with one all_reduce;
    a no-op without a group. The group's backend decides where it may run:
    NCCL needs CUDA tensors, gloo takes CPU and CUDA ones. Every process
    gets the same sums."""
    import torch.distributed as dist

    return _flat_collective(
        tensors, lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM))


def broadcast_from_first(tensors):
    """Overwrite each tensor, in place, with process 0's (one broadcast
    over an initialised group; a no-op without one): how data-parallel
    training starts every process from the same weights."""
    import torch.distributed as dist

    return _flat_collective(tensors, lambda flat: dist.broadcast(flat, 0))


def local_shard(items: Sequence[T], process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> List[T]:
    """This process's strided share of a global work list."""
    pi, pc = process_rank_count()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    return list(items[pi::pc])


class Progress:
    """Plain-stderr progress meter (the Ray actor + tqdm poll loop collapses
    to a local counter once workers are SPMD shards, not actors)."""

    def __init__(self, total: int, desc: str = "", report_every: float = 5.0):
        self.total = total
        self.desc = desc
        self.done = 0
        self._last = 0.0
        self._t0 = time.time()
        self.report_every = report_every

    def update(self, n: int = 1):
        self.done += n
        now = time.time()
        if now - self._last >= self.report_every or self.done >= self.total:
            rate = self.done / max(now - self._t0, 1e-9)
            print(
                f"[{self.desc}] {self.done}/{self.total} ({rate:.2f}/s)",
                file=sys.stderr,
            )
            self._last = now


def run_scenes(
    scene_fn: Callable[[T], Dict],
    scenes: Sequence[T],
    on_error: str = "log",  # "log" | "raise"
) -> Dict[str, Dict]:
    """Run scenes serially on this process with per-scene crash isolation
    (reference eval_dataset.py:88-92 catches and logs worker exceptions)."""
    results: Dict[str, Dict] = {}
    prog = Progress(len(scenes), desc="scenes")
    for s in scenes:
        key = str(s)
        try:
            results[key] = scene_fn(s)
        except Exception as e:  # noqa: BLE001
            if on_error == "raise":
                raise
            print(f"scene {key} failed: {e!r}", file=sys.stderr)
            results[key] = {"status": "failed", "error": repr(e)}
        prog.update()
    return results


def allgather_objects(obj):
    """All-gather one JSON-serialisable object per process over an
    initialised torch.distributed group. Returns a list with one object
    per process (all processes get all); [obj] without a group."""
    pc = process_rank_count()[1]
    if pc == 1:
        return [obj]
    import torch.distributed as dist

    out: List = [None] * pc
    dist.all_gather_object(out, json.loads(json.dumps(obj)))
    return out


def run_eval_scenes(scenes, scene_fn, output_dir: str,
                    imc_bags: bool = False, title: str = "dataset",
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None):
    """Dataset evaluation loop: each process reconstructs its strided
    shard exactly once (per-scene isolation: a scene that raises is a
    failed scene, not a failed run), prints one JSON line per scene
    ({"scene", "wall_s", ...scene_fn's result}), per-scene metrics are
    all-gathered, and process 0 writes the aggregated metrics.txt.

    scene_fn(scene_name) -> result dict (keys: status, n_registered,
    n_images, pose_auc?). Returns (per_scene_metrics, report) on process 0
    and (None, None) elsewhere. process_index / process_count override the
    group's; without a group only this process's share is aggregated."""
    from ..eval.aggregate import aggregate_multi_scene_metrics, format_report

    pi, pc = process_rank_count()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    mine = local_shard(scenes, pi, pc)
    local: Dict[str, Dict] = {}
    for s in mine:
        print(f"=== scene {s} (proc {pi}) ===", file=sys.stderr)
        t0 = time.perf_counter()
        try:
            res = scene_fn(s)
        except Exception as e:  # noqa: BLE001 (per-scene isolation)
            print(f"scene {s} failed: {e}", file=sys.stderr)
            res = {"status": "failed", "error": repr(e)}
        dt = time.perf_counter() - t0
        print(json.dumps({"scene": s, "wall_s": round(dt, 1), **res}),
              flush=True)
        metrics = dict(res.get("pose_auc", {}) or {})
        metrics["registered_ratio"] = (
            res.get("n_registered", 0) / max(res.get("n_images", 1), 1)
        )
        # Scene-level throughput: the first scene of a process carries
        # the set-up (weights, cuDNN's algorithm timing), later ones the
        # warm steady state.
        metrics["wall_s"] = round(dt, 1)
        local[s] = metrics
    per_scene: Dict[str, Dict] = {}
    for d in allgather_objects(local):
        per_scene.update(d)
    if pi != 0:
        return None, None
    agg = aggregate_multi_scene_metrics(per_scene, group_bags=imc_bags)
    report = format_report(agg, per_scene, title=title)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "metrics.txt"), "w") as f:
        f.write(report + "\n")
    print(report)
    return per_scene, report
