"""Iterative refinement driver: multiview matching + geometry refinement.

Port of the JAX package's refine/loop.py. Per iteration:

  1. pack all tracks into one flat table (refine/bags.py::pack_track_table)
     and refine every query node's 2D location with the MultiviewRefiner
     (window shrinks per iteration, 15 -> 11 -> 7), in chunks of
     pad_to_multiple(max(chunk_tracks, n), n) rows for the n "data" rows
     of the mesh (parallel/mesh.py), each chunk split into n contiguous
     blocks, one per device, with the scene's image stack and the refiner
     replicated once per distinct device; a 1-deep dispatch/collect
     overlap (as match/engine.py): the host writes chunk i back, in row
     order, while the devices run chunk i+1;
  2. write refined keypoints back into the reconstruction;
  3. geometry refinement: retriangulation, track merge and completion,
     global BA with the farthest registered pair as gauge (with
     `fix_all_poses`, the known-pose triangulation mode, structure-only BA
     with every registered pose frozen), and reprojection/angle filtering
     at per-iteration thresholds [3, 2, 1.5] px;
  4. re-register dropped images on even iterations (not with
     `fix_all_poses`).

The three steps open the JAX package's profiler scopes through a
PassThroughProfiler (utils/profiler.py): `refine/pack_tracks`,
`refine/multiview_match` and `refine/geometry_refinement`, seen in a
`trace_to` trace. As in JAX, there is no `profiler=` argument. Under a
torch profiler the multiview match also records the spans `refine/stage`
(pad and shard a chunk onto the cards), `refine/launch` (enqueue the
refiner on each card), `refine/wait` (the blocking copy of the refined
coordinates to the host) and `refine/writeback` (the loop that writes
them into the reconstruction's keypoints).

A failed iteration restores the model it started from and ends the loop
(the reference's failure isolation). The failure is not hidden: pass
`info={}` and it receives `iterations_completed`, `error` (the caught
exception's repr, or None) and `device_error` (whether that exception was
a fault of the card or its libraries, device.is_device_error), with
per-iteration counts and times.

The refiner runs in float32 with TF32 off for cuBLAS and cuDNN (as the
matcher), so the card stays comparable with the fp32 JAX reference;
`RefineConfig.compute_dtype="bfloat16"` runs it in bf16 as JAX's does
(models/multiview_matcher.py), with bf16 GEMMs reduced in fp32. Unlike
the matcher it leaves cuDNN's benchmark mode off: timing the algorithms of
a 8 192-patch chunk costs 16.4 s at crop 19 and 9.4 s at crop 15 on an
H100, against 0.256 and 0.170 s a chunk with the heuristic's picks (0.234
and 0.140 s with the timed ones; `tools/refiner_bench.py`), so it pays off
only past ~700 chunks an iteration.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.geometry import np_quat_to_rotmat
from ..core.precision import geometry_precision
from ..device import bf16_reduced_in_fp32, is_device_error
from ..models.multiview_matcher import MultiviewRefiner, RefinerConfig
from ..parallel.mesh import (mesh_of, pad_to_multiple, replicate,
                             replicate_module, shard_leading_axis)
from ..sfm.mapper import IncrementalMapper, MapperConfig
from ..sfm.reconstruction import Reconstruction
from ..utils.profiler import PassThroughProfiler, span
from .bags import pack_track_table


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    n_iters: int = 2
    windows: tuple = (15, 11, 7)       # per-iteration attention window
    crop_extra: int = 4                # backbone context beyond the window
    filter_thresholds: tuple = (3.0, 2.0, 1.5)  # px, per iteration; also the
                                       # tri-merge / tri-complete thresholds
    min_tri_angle_deg: float = 1.5
    max_track_length: int = 16
    chunk_tracks: int = 512
    reregister_every: int = 2
    # Relaxed re-registration thresholds (reference reregistration.py:35-46)
    rereg_abs_pose_max_error: float = 20.0
    rereg_min_num_inliers: int = 15
    rereg_min_inlier_ratio: float = 0.1
    # Random refiner weights only perturb keypoints; tests opt in.
    allow_random_weights: bool = False
    # Triangulation mode: known poses stay frozen through refinement BA
    # (the reference's fix_all_images when refining 3D points only) and
    # PnP re-registration is skipped.
    fix_all_poses: bool = False
    # The refiner's compute dtype ("float32" or "bfloat16"). As in JAX it
    # is set through this config only: the pipeline and the CLI leave it
    # at float32, whatever the matcher's dtype.
    compute_dtype: str = "float32"
    save_iters_to: Optional[str] = None  # write model_refined_{i}/ per
                                         # completed iteration


def _farthest_pair(rec: Reconstruction) -> set:
    reg = rec.registered_images
    if len(reg) < 2:
        return set(reg)
    q = np.stack([rec.images[i].qvec for i in reg])
    t = np.stack([rec.images[i].tvec for i in reg])
    R = np_quat_to_rotmat(np.asarray(q, np.float64))
    C = -np.einsum("nji,nj->ni", R, t)
    d2 = np.sum((C[:, None] - C[None, :]) ** 2, axis=-1)
    a, b = np.unravel_index(int(np.argmax(d2)), d2.shape)
    return {reg[a], reg[b]}


def _pad_tracks(arr: np.ndarray, t_pad: int, fill=0):
    if len(arr) == t_pad:
        return arr
    pad = np.full((t_pad - len(arr),) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad])


def refine_reconstruction(
    rec: Reconstruction,
    images_by_id: Dict[int, np.ndarray],   # image_id -> (H, W) float [0,1]
    params: Optional[Dict[str, torch.Tensor]] = None,
    cfg: RefineConfig = RefineConfig(),
    mapper: Optional[IncrementalMapper] = None,
    seed: int = 0,
    verbose: bool = False,
    device=None,
    info: Optional[dict] = None,
    mesh=None,
) -> Reconstruction:
    """Refine a reconstruction in place (also returned), on `mesh` or on
    a one-entry mesh of `device` (neither: the default mesh, which needs
    CUDA); geometry refinement runs on the mesh's first device.

    params is the refiner's state_dict (utils.checkpoint.
    load_refiner_params); None needs cfg.allow_random_weights, and then
    the refiner is initialised from `seed`. All images are padded to the
    largest (H, W) and staged once on each device of the mesh."""
    if params is None and not cfg.allow_random_weights:
        raise ValueError(
            "refine_reconstruction called without refiner weights: pass "
            "params=<MultiviewRefiner state_dict> (e.g. utils.checkpoint."
            "load_refiner_params('weights/demo_refiner_r4_bf16.msgpack')), "
            "or opt in to random weights with "
            "RefineConfig(allow_random_weights=True).")
    mesh = mesh_of(device, mesh)
    info = {} if info is None else info
    info.update(iterations_completed=0, error=None, device_error=False,
                iterations=[])

    image_order = sorted(images_by_id)
    Hmax = max(im.shape[0] for im in images_by_id.values())
    Wmax = max(im.shape[1] for im in images_by_id.values())
    img_stack = np.zeros((len(image_order), Hmax, Wmax, 1), np.float32)
    for gi, img_id in enumerate(image_order):
        a = images_by_id[img_id]
        img_stack[gi, : a.shape[0], : a.shape[1], 0] = a
    images_dev = replicate(torch.from_numpy(img_stack), mesh)

    for it in range(cfg.n_iters):
        # Failure isolation (reference post_optimization.py:195-197: a
        # failed geometry-refinement iteration falls back to the unrefined
        # model)
        snapshot = copy.deepcopy((
            {i: (im.qvec.copy() if im.registered else None,
                 im.tvec.copy() if im.registered else None,
                 im.xys.copy(), im.point3D_ids.copy())
             for i, im in rec.images.items()},
            {p: {"xyz": pt["xyz"].copy(), "track": list(pt["track"])}
             for p, pt in rec.points.items()},
        ))
        try:
            info["iterations"].append(_refine_iteration(
                rec, images_dev, image_order, params, cfg, mapper, seed,
                verbose, it, mesh))
            if cfg.save_iters_to:
                d = os.path.join(cfg.save_iters_to, f"model_refined_{it}")
                os.makedirs(d, exist_ok=True)
                rec.write(d)
            info["iterations_completed"] = it + 1
        except Exception as e:  # noqa: BLE001
            info["error"] = repr(e)
            info["device_error"] = is_device_error(e)
            if verbose:
                print(f"refine iter {it} failed ({e!r}); keeping previous model")
            img_snap, pt_snap = snapshot
            for i, (q, t, xys, pids) in img_snap.items():
                im = rec.images[i]
                im.qvec, im.tvec = q, t
                im.xys, im.point3D_ids = xys, pids
            rec.points = {
                p: {"xyz": d["xyz"], "rgb": rec.points.get(p, {}).get(
                    "rgb", np.array([128, 128, 128], np.uint8)),
                    "error": -1.0, "track": d["track"]}
                for p, d in pt_snap.items()
            }
            break
    return rec


def _build_refiner(rcfg: RefinerConfig, params, seed: int, dev):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)  # random init only; weights overwrite it
        model = MultiviewRefiner(rcfg)
    if params is not None:
        model.load_state_dict(params)
    return model.to(dev).eval()


def _refine_iteration(rec, images_dev, image_order, params, cfg, mapper,
                      seed, verbose, it, mesh) -> dict:
    profiler = PassThroughProfiler()
    window = cfg.windows[min(it, len(cfg.windows) - 1)]
    rcfg = RefinerConfig(crop_size=window + cfg.crop_extra, window=window,
                         compute_dtype=cfg.compute_dtype)
    dev = mesh.first
    # The refiner replicated: one copy per distinct device.
    models = replicate_module(_build_refiner(rcfg, params, seed, dev), mesh)

    t0 = time.perf_counter()
    with profiler.record_function("refine/pack_tracks"):
        table = pack_track_table(rec, max_track_length=cfg.max_track_length)
    pack_s = time.perf_counter() - t0
    # Reconcile table image indices with the staged global stack. Images
    # never referenced by a node may be absent from the stack; map them to
    # 0 — their mask is always False.
    img_pos = {img_id: gi for gi, img_id in enumerate(image_order)}
    remap = np.asarray([img_pos.get(i, 0) for i in table.image_ids],
                       np.int64)
    node_img_g = remap[table.node_img]
    T_total = len(table.point_ids)
    n_dev = len(models)
    chunk = pad_to_multiple(max(cfg.chunk_tracks, n_dev), n_dev)
    if verbose:
        print(f"refine iter {it}: {T_total} tracks, window {window}, "
              f"chunks of {chunk} over {n_dev} devices")
    cuda = dev.type == "cuda"
    forward_ms, shifts = [], []

    def dispatch(start):
        """Stage one track chunk and launch each device's block
        (asynchronous on the cards)."""
        end = min(start + chunk, T_total)
        with span("refine/stage"):
            blocks = shard_leading_axis(
                (_pad_tracks(node_img_g[start:end], chunk),
                 _pad_tracks(table.node_xy[start:end], chunk),
                 _pad_tracks(table.node_scale[start:end], chunk, 1.0),
                 _pad_tracks(table.node_mask[start:end], chunk)), mesh)
        evs, outs = [], []
        t0 = time.perf_counter()
        with span("refine/launch"):
            for model, images, batch in zip(models, images_dev, blocks):
                if cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record(torch.cuda.current_stream(images.device))
                # Full fp32 products and bf16 GEMMs reduced in fp32,
                # whichever the refiner's dtype; cuDNN's heuristic
                # algorithms (see above).
                with geometry_precision(), bf16_reduced_in_fp32(), \
                        torch.backends.cudnn.flags(
                            enabled=True, benchmark=False,
                            deterministic=False, allow_tf32=False), \
                        torch.no_grad():
                    outs.append(model(images, *batch))
                if cuda:
                    ev[1].record(torch.cuda.current_stream(images.device))
                    evs.append(ev)
        if not cuda:
            evs = (time.perf_counter() - t0) * 1e3
        return start, end - start, outs, evs

    def collect(start, n, outs, evs):
        with span("refine/wait"):
            coords = torch.cat([o.coords.cpu() for o in outs])[:n].numpy()
        # A chunk's device ms: its slowest block's.
        forward_ms.append(max(a.elapsed_time(b) for a, b in evs) if cuda
                          else evs)
        mq = table.node_mask[start:start + n, 1:]
        shifts.append(np.linalg.norm(
            coords[:, 1:][mq] - table.node_xy[start:start + n, 1:][mq],
            axis=1))
        # Write refined query observations back into image keypoints
        with span("refine/writeback"):
            for r in range(n):
                pid = table.point_ids[start + r]
                if pid not in rec.points:
                    continue
                for vpos in range(1, coords.shape[1]):
                    if not table.node_mask[start + r, vpos]:
                        continue
                    img_id = table.image_ids[table.node_img[start + r, vpos]]
                    kpt = int(table.node_kpt[start + r, vpos])
                    rec.images[img_id].xys[kpt] = coords[r, vpos]

    t0 = time.perf_counter()
    with profiler.record_function("refine/multiview_match"):
        pending = None
        for start in range(0, T_total, chunk):
            nxt = dispatch(start)
            if pending is not None:
                collect(*pending)
            pending = nxt
        if pending is not None:
            collect(*pending)
    match_s = time.perf_counter() - t0
    moved = np.concatenate(shifts) if shifts else np.zeros(0)

    # Geometry refinement (the reference's incremental_model_refiner:
    # retriangulate + merge + complete + BA + filter, all at this
    # iteration's threshold)
    m = mapper or IncrementalMapper(MapperConfig(), device=dev)
    if not hasattr(m, "names"):
        # allow running on a standalone reconstruction
        m.names = [im.name for im in rec.images.values()]
        m.name_to_id = {im.name: i for i, im in rec.images.items()}
    thr = cfg.filter_thresholds[min(it, len(cfg.filter_thresholds) - 1)]
    t0 = time.perf_counter()
    with profiler.record_function("refine/geometry_refinement"):
        m.retriangulate(rec)  # structure follows the refined 2D points
        n_merged = m.merge_tracks(rec, thr)
        n_completed = (
            m.complete_tracks(rec, thr) if hasattr(m, "kpt_track") else 0
        )
        if cfg.fix_all_poses:  # triangulation mode: structure-only BA
            m.global_ba(rec, fixed_ids=set(rec.registered_images),
                        gauge="full")
        else:
            m.global_ba(rec, fixed_ids=_farthest_pair(rec))
        n_rm = m.filter_points(rec, thr, cfg.min_tri_angle_deg)
    geometry_s = time.perf_counter() - t0
    if verbose:
        print(f"  BA done at {thr}px: merged {n_merged}, "
              f"completed {n_completed}, filtered {n_rm}")

    # Re-registration of dropped images (even iterations), relaxed thresholds
    reregistered = []
    t0 = time.perf_counter()
    if ((it % cfg.reregister_every) == 0 and mapper is not None
            and not cfg.fix_all_poses):
        for img_id in list(rec.images):
            if not rec.images[img_id].registered:
                ok = mapper._try_register(
                    rec, img_id,
                    abs_pose_max_error=cfg.rereg_abs_pose_max_error,
                    min_num_inliers=cfg.rereg_min_num_inliers,
                    min_inlier_ratio=cfg.rereg_min_inlier_ratio,
                )
                if ok:
                    reregistered.append(img_id)
                    if verbose:
                        print(f"  re-registered image {img_id}")
    return dict(tracks=T_total, window=window, chunks=len(forward_ms),
                forward_ms=forward_ms, pack_s=pack_s, match_s=match_s,
                median_shift_px=float(np.median(moved)) if len(moved)
                else 0.0,
                geometry_s=geometry_s, reregister_s=time.perf_counter() - t0,
                merged=n_merged, completed=n_completed, filtered=n_rm,
                reregistered=reregistered)
