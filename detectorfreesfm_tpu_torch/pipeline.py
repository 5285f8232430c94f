"""Scene reconstruction pipeline: match -> SfM -> refine -> evaluate.

Port of the JAX package's pipeline.py. Stage artifacts are
persisted under the output dir and stages are skipped when their outputs
exist (redo_* flags force re-runs), so scenes are resumable:

  keypoints.h5 / matches.h5   the match store (data/h5io.py; where h5py is
                              absent it writes keypoints.h5.npz, and the
                              stage check looks for the file written,
                              `h5io.stored_path`)
  database.db                 COLMAP database export (best-effort)
  colmap_coarse/              the mapper's model, with point colours
  model_refined_{i}/          the model after each refinement iteration
  colmap_refined/             the final model, points.ply and
                              cameras_points.ply (best-effort)
  stage_times.json            seconds of match, coarse_sfm, io and refine

Two modes:

  * from-scratch SfM: coarse matching -> incremental mapper -> iterative
    multiview refinement;
  * triangulation (known poses, the ETH3D protocol): poses and intrinsics
    come from txt dirs ({img}.txt holding a 4x4 w2c matrix); cameras stay
    fixed and only structure is estimated (verified matches, tracks, DLT,
    structure-only BA) and refined.

Every entry point takes `device=` (a one-entry mesh of it; tests pass
"cpu") or `mesh=` (parallel/mesh.py); neither means the default mesh,
every visible card (CUDA must be present). As in JAX, matching and
refinement shard over the mesh, and the mapper runs on its first device
(its global BA shards over the default mesh when that holds several
cards, sfm/mapper.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .data import colmap_io
from .data.h5io import load_h5, save_h5, stored_path
from .data.images import image_size, load_gray
from .eval.pose_auc import DEFAULT_THRESHOLDS
from .match.engine import EngineConfig, PairMatchingEngine
from .match.pairs import exhaustive_pairs, sequential_pairs
from .models import LOFTR_FAMILY
from .parallel.mesh import mesh_of
from .refine.loop import RefineConfig, refine_reconstruction
from .sfm.mapper import IncrementalMapper, MapperConfig
from .sfm.reconstruction import Reconstruction

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")

# Process-wide matcher-engine cache (see reconstruct_scene): dataset runs
# call reconstruct_scene once per scene with the same params/config.
_ENGINE_CACHE: dict = {}


@dataclasses.dataclass
class PipelineConfig:
    # matching
    matcher: str = "loftr"  # models.build_matcher: loftr, aspan,
    # matchformer, efficientloftr
    img_resize: int = 832
    match_threshold: float = 0.2
    max_matches: int = 2048
    round_matches_ratio: Optional[int] = None
    batch_size: int = 1
    compute_dtype: str = "float32"  # the matcher's; refinement keeps
                                    # refine.compute_dtype, as in JAX
    fused_matching: bool = False
    # "coarse_only" (default) or "coarse_fine" (sub-pixel fine stage; the
    # reference's TexturePoorSfM protocol pairs it with round ratio 4)
    match_type: str = "coarse_only"
    # sfm
    mapper: MapperConfig = dataclasses.field(default_factory=MapperConfig)
    # refinement
    refine: RefineConfig = dataclasses.field(default_factory=RefineConfig)
    n_refine_iters: int = 2
    # pairs
    pair_mode: str = "exhaustive"  # or "sequential"
    sequential_window: int = 10
    # stage control
    redo_matching: bool = False
    redo_sfm: bool = False
    redo_refine: bool = False
    triangulation_mode: bool = False  # known poses (reconstruct_scene's
                                      # `poses`) stay fixed
    n_images: Optional[int] = None  # debug clamp (reference base.yaml:33)
    # Detector-free keypoints live on an 8px grid at *network* resolution;
    # mapper thresholds are original-resolution pixels. When images are
    # much larger than img_resize, a grid cell spans many original pixels
    # and fixed thresholds starve RANSAC: scale them by the mean resize
    # factor.
    auto_scale_thresholds: bool = True

    def engine_config(self) -> EngineConfig:
        fine = self.match_type == "coarse_fine"
        round_ratio = self.round_matches_ratio
        if fine and round_ratio is None:
            # Fine endpoints are continuous; tracks need shared keypoints.
            # The reference's coarse_fine protocol rounds to a 4px grid.
            round_ratio = 4
        return EngineConfig(
            matcher=self.matcher,
            img_resize=self.img_resize, match_threshold=self.match_threshold,
            max_matches=self.max_matches, batch_size=self.batch_size,
            round_matches_ratio=round_ratio,
            compute_dtype=self.compute_dtype,
            # The fused kernels take the LoFTR family's coarse features;
            # ASpan and MatchFormer match densely, as in JAX.
            fused_matching=self.fused_matching and self.matcher in
            LOFTR_FAMILY,
            fine_enabled=fine,
        )


def list_scene_images(image_dir: str, n_images: Optional[int] = None
                      ) -> List[str]:
    names = sorted(
        f for f in os.listdir(image_dir)
        if f.lower().endswith(IMG_EXTS)
    )
    if n_images:
        # Even subsample, like the reference's down_sample_ratio clamp
        idx = np.linspace(0, len(names) - 1, n_images).astype(int)
        names = [names[i] for i in sorted(set(idx.tolist()))]
    return names


def read_pose_txt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """4x4 world-to-camera matrix txt -> (qvec, tvec)."""
    from .core.geometry import np_rotmat_to_quat

    m = np.loadtxt(path).reshape(4, 4)
    R, t = m[:3, :3], m[:3, 3]
    return np_rotmat_to_quat(np.asarray(R, np.float64)), t


def read_intrin_txt(path: str) -> np.ndarray:
    vals = np.loadtxt(path)
    return vals.reshape(3, 3) if vals.size == 9 else vals


def match_stores(out_dir: str) -> Tuple[str, str]:
    """The paths of the keypoint and match stores under out_dir (as given
    to save_h5/load_h5; the file written is h5io.stored_path of each)."""
    return (os.path.join(out_dir, "keypoints.h5"),
            os.path.join(out_dir, "matches.h5"))


def matches_stored(out_dir: str) -> bool:
    """Whether both match stores exist, in whichever format h5io writes."""
    return all(os.path.exists(stored_path(p)) for p in match_stores(out_dir))


def _match_stage(
    cfg: PipelineConfig, image_dir: str, names: List[str], out_dir: str,
    engine: Optional[PairMatchingEngine] = None, where=None,
):
    kp_path, mt_path = match_stores(out_dir)
    if not cfg.redo_matching and matches_stored(out_dir):
        kps = load_h5(kp_path)
        raw = load_h5(mt_path)
        matches = {}
        for key, arr in raw.items():
            a, b = key.split("|")
            matches[(a, b)] = arr.astype(np.int32)
        return dict(kps), matches

    if engine is None:
        engine = PairMatchingEngine(cfg.engine_config(), **(where or {}))
    pairs = (
        exhaustive_pairs(names) if cfg.pair_mode == "exhaustive"
        else sequential_pairs(names, cfg.sequential_window)
    )
    paths = {n: os.path.join(image_dir, n) for n in names}
    keypoints, _scores, match_indices, _raw = engine.match_scene(pairs, paths)
    os.makedirs(out_dir, exist_ok=True)
    save_h5(keypoints, kp_path)
    save_h5({f"{a}|{b}": v for (a, b), v in match_indices.items()}, mt_path)
    return keypoints, match_indices


def _image_sizes(image_dir: str, names: List[str]) -> Dict[str, tuple]:
    return {n: image_size(os.path.join(image_dir, n)) for n in names}


def reconstruct_scene(
    image_dir: str,
    output_dir: str,
    cfg: PipelineConfig = PipelineConfig(),
    intrinsics: Optional[Dict[str, np.ndarray]] = None,
    poses: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
    matcher_params=None,
    refiner_params=None,
    verbose: bool = False,
    device=None,
    info: Optional[dict] = None,
    mesh=None,
) -> Optional[Reconstruction]:
    """Full pipeline for one scene on `mesh` or `device` (see above). Returns the refined
    Reconstruction (and writes colmap_coarse/ + colmap_refined/ under
    output_dir). `poses` ({image name: (qvec, tvec)}, world-to-camera)
    feeds the triangulation mode, which requires it; a stored
    colmap_coarse/ is reused in either mode.

    Pass `info={}` to receive how refinement ended, which the JAX package
    only prints: `refine_iterations_completed`, `refine_error` (the caught
    exception's repr, or None) and `refine_device_error` (whether it was a
    fault of the card). A run that reuses a stored colmap_refined/ counts
    the model_refined_{i}/ it finds and knows no error."""
    # The engine and refinement get the caller's device or mesh; the
    # mapper runs on the mesh's first device.
    where = {"device": device} if mesh is None else {"mesh": mesh}
    mesh = mesh_of(device, mesh)
    dev = mesh.first
    coarse_dir = os.path.join(output_dir, "colmap_coarse")
    coarse_stored = (not cfg.redo_sfm and os.path.isdir(coarse_dir)
                     and bool(os.listdir(coarse_dir)))
    if cfg.triangulation_mode and poses is None and not coarse_stored:
        # Before any work (the JAX package raises this after matching).
        raise ValueError("triangulation_mode requires poses: a scene dir "
                         "with poses/ (4x4 world-to-camera matrices)")
    info = {} if info is None else info
    info.update(refine_iterations_completed=0, refine_error=None,
                refine_device_error=False)
    os.makedirs(output_dir, exist_ok=True)
    # Per-stage wall profile, written to stage_times.json so scene
    # throughput decomposes into match / coarse_sfm / io / refine.
    stage_t: Dict[str, float] = {}
    t0 = time.time()

    def mark(stage):
        nonlocal t0
        now = time.time()
        stage_t[stage] = stage_t.get(stage, 0.0) + (now - t0)
        t0 = now

    names = list_scene_images(image_dir, cfg.n_images)
    if len(names) < 2:
        return None
    sizes = _image_sizes(image_dir, names)

    engine = None
    if matcher_params is not None:
        # Engine reuse across scenes (same params, config and mesh); one
        # live engine, since its weights sit on the devices.
        key = (id(matcher_params), cfg.engine_config(), mesh.key())
        engine = _ENGINE_CACHE.get(key)
        if engine is None:
            engine = PairMatchingEngine(
                cfg.engine_config(), params=matcher_params, **where)
            _ENGINE_CACHE.clear()
            _ENGINE_CACHE[key] = engine
    keypoints, match_indices = _match_stage(
        cfg, image_dir, names, output_dir, engine, where)
    mark("match")
    # COLMAP SQLite artifact for external tooling
    db_path = os.path.join(output_dir, "database.db")
    if not os.path.exists(db_path):
        from .data.database import export_scene_to_database

        try:
            export_scene_to_database(
                db_path, keypoints, match_indices, sizes, intrinsics)
        except Exception as e:  # noqa: BLE001
            # Interop artifact only; never block reconstruction, but say so.
            print(f"warning: database.db export failed: {e!r}")

    mapper_cfg = cfg.mapper
    if cfg.auto_scale_thresholds:
        f = float(np.mean([max(w, h) for (w, h) in sizes.values()]))
        f = max(1.0, f / cfg.img_resize)
        mapper_cfg = dataclasses.replace(
            mapper_cfg,
            geometry_verify_thr=cfg.mapper.geometry_verify_thr * f,
            init_max_error=cfg.mapper.init_max_error * f,
            abs_pose_max_error=cfg.mapper.abs_pose_max_error * f,
            filter_max_reproj_error=cfg.mapper.filter_max_reproj_error * f,
            tri_merge_max_reproj_error=(
                cfg.mapper.tri_merge_max_reproj_error * f),
            tri_complete_max_reproj_error=(
                cfg.mapper.tri_complete_max_reproj_error * f),
        )
    mapper = IncrementalMapper(mapper_cfg, device=dev)
    coarse_resumed = False
    if coarse_stored:
        coarse_resumed = True
        cams, imgs, pts = colmap_io.read_model(coarse_dir)
        rec = Reconstruction.from_colmap(cams, imgs, pts)
        mapper.names = sorted(keypoints)
        mapper.name_to_id = {im.name: i for i, im in rec.images.items()}
        _rebuild_mapper_tracks(mapper, rec, keypoints, match_indices)
    elif cfg.triangulation_mode:
        rec = _triangulate_known_poses(
            mapper, keypoints, match_indices, sizes, intrinsics, poses)
    else:
        rec = mapper.run(
            keypoints, match_indices, sizes, intrinsics, verbose=verbose)
    mark("coarse_sfm")
    if rec is None:
        return None
    os.makedirs(coarse_dir, exist_ok=True)
    if not coarse_resumed:
        rec.extract_colors(image_dir)
    rec.write(coarse_dir)
    mark("io")

    # Refinement (resumable: a completed colmap_refined/ is reused unless
    # the SfM stage was re-run above or redo_refine forces it)
    refined_dir = os.path.join(output_dir, "colmap_refined")
    if (not cfg.redo_refine and coarse_resumed
            and os.path.isdir(refined_dir)
            and os.path.exists(os.path.join(refined_dir, "images.bin"))):
        cams, imgs, pts = colmap_io.read_model(refined_dir)
        done = 0
        while os.path.isdir(os.path.join(output_dir,
                                         f"model_refined_{done}")):
            done += 1
        info["refine_iterations_completed"] = done
        return Reconstruction.from_colmap(cams, imgs, pts)
    if cfg.n_refine_iters > 0:
        # Refinement runs at network resolution: keypoints AND intrinsics
        # move into network pixel units together (mixing original-res K
        # with network-res xys silently destroys the geometry in BA), then
        # both scale back afterwards.
        from concurrent.futures import ThreadPoolExecutor

        ids = list(rec.images)
        with ThreadPoolExecutor(max_workers=8) as pool:
            loaded = list(pool.map(
                lambda i: load_gray(
                    os.path.join(image_dir, rec.images[i].name),
                    long_side=cfg.img_resize, pad_to=cfg.img_resize,
                ),
                ids,
            ))
        images_by_id = {}
        scales = {}
        for img_id, li in zip(ids, loaded):
            im = rec.images[img_id]
            images_by_id[img_id] = li.data
            scales[img_id] = li.scale
            im.xys = im.xys / li.scale[None, :]
            rec.cameras[im.camera_id].rescale(
                1.0 / li.scale[0], 1.0 / li.scale[1])
        rcfg = dataclasses.replace(
            cfg.refine, n_iters=cfg.n_refine_iters, save_iters_to=output_dir,
            # Known-pose triangulation keeps the poses frozen through
            # refinement (the reference's fix_all_images)
            fix_all_poses=cfg.triangulation_mode or cfg.refine.fix_all_poses)
        loop_info: dict = {}
        refine_reconstruction(
            rec, images_by_id, params=refiner_params, cfg=rcfg,
            mapper=mapper, verbose=verbose, info=loop_info, **where)
        info.update(
            refine_iterations_completed=loop_info["iterations_completed"],
            refine_error=loop_info["error"],
            refine_device_error=loop_info["device_error"])
        if loop_info["error"] is not None:
            # The loop keeps the last good model, as the reference does;
            # the failure is reported, not hidden.
            print(f"warning: refinement stopped after "
                  f"{loop_info['iterations_completed']} of {rcfg.n_iters} "
                  f"iterations: {loop_info['error']}", file=sys.stderr)
        mark("refine")
        # back to original pixels
        for img_id, im in rec.images.items():
            sc = scales[img_id]
            im.xys = im.xys * sc[None, :]
            rec.cameras[im.camera_id].rescale(sc[0], sc[1])
    os.makedirs(refined_dir, exist_ok=True)
    # Refinement merges/completes/filters tracks, so re-extract colors for
    # the final model.
    rec.extract_colors(image_dir)
    rec.write(refined_dir)
    # Viewer-friendly dumps
    colmap_io.write_ply(
        rec.to_colmap()[2], os.path.join(refined_dir, "points.ply"))
    try:
        from .utils.vis import export_reconstruction_ply

        export_reconstruction_ply(
            rec, os.path.join(refined_dir, "cameras_points.ply"))
    except Exception as e:  # noqa: BLE001 (best-effort, but visible)
        print(f"warning: camera/points PLY export failed: {e!r}")
    mark("io")
    try:
        with open(os.path.join(output_dir, "stage_times.json"), "w") as f:
            json.dump({k: round(v, 2) for k, v in stage_t.items()}, f)
    except OSError:
        pass
    return rec


def _rebuild_mapper_tracks(mapper, rec, keypoints, match_indices):
    """Restore the mapper's track bookkeeping from a loaded model (for
    resume: re-registration needs kpt->track maps)."""
    from .sfm.tracks import build_tracks

    n_kpts = {mapper.name_to_id[n]: len(keypoints[n]) for n in mapper.names
              if n in mapper.name_to_id}
    vm = {
        (mapper.name_to_id[a], mapper.name_to_id[b]): m
        for (a, b), m in match_indices.items()
        if a in mapper.name_to_id and b in mapper.name_to_id
    }
    tracks = build_tracks(n_kpts, vm)
    mapper.tracks = tracks
    mapper.track_pid = np.full(len(tracks), -1, np.int64)
    mapper.kpt_track = {}
    for tid, t in enumerate(tracks):
        for (img_id, kpt) in t.observations:
            mapper.kpt_track.setdefault(img_id, {})[kpt] = tid
    for pid, pt in rec.points.items():
        for (img_id, kpt) in pt["track"]:
            tid = mapper.kpt_track.get(img_id, {}).get(kpt)
            if tid is not None:
                mapper.track_pid[tid] = pid


def _triangulate_known_poses(
    mapper: IncrementalMapper, keypoints, match_indices, sizes,
    intrinsics, poses,
) -> Optional[Reconstruction]:
    """Known-pose triangulation (the reference's point_triangulator): fix
    all cameras, verify pairs, build tracks, triangulate, BA structure-only,
    filter."""
    from .sfm.tracks import build_tracks

    cfg = mapper.cfg
    rec = mapper._setup(keypoints, sizes, intrinsics)
    for n, (q, t) in poses.items():
        if n in mapper.name_to_id:
            rec.set_pose(mapper.name_to_id[n], q, t)
    verified = mapper.verify_pairs(rec, match_indices)
    if not verified:
        return None
    n_kpts = {mapper.name_to_id[n]: len(keypoints[n]) for n in mapper.names}
    vm = {pair: v["matches"] for pair, v in verified.items()}
    tracks = build_tracks(n_kpts, vm)
    mapper.tracks = tracks
    mapper.track_pid = np.full(len(tracks), -1, np.int64)
    mapper.kpt_track = {}
    for tid, t in enumerate(tracks):
        for (img_id, kpt) in t.observations:
            mapper.kpt_track.setdefault(img_id, {})[kpt] = tid
    tri = mapper._triangulate_tracks(
        rec, tracks, range(len(tracks)),
        cfg.min_tri_angle_deg, cfg.filter_max_reproj_error)
    for tid, (xyz, obs) in tri.items():
        pid = rec.add_point(xyz, obs)
        if pid >= 0:
            mapper.track_pid[tid] = pid
    # Structure-only BA: every camera fixed completely (gauge="full"); with
    # exactly 2 known-pose cameras the similarity gauge would re-optimise
    # the second pose.
    mapper.global_ba(rec, fixed_ids=set(rec.registered_images), gauge="full")
    mapper.filter_points(rec, cfg.filter_max_reproj_error,
                         cfg.min_tri_angle_deg)
    return rec


def evaluate_scene_poses(
    rec: Reconstruction,
    gt_poses: Dict[str, Tuple[np.ndarray, np.ndarray]],
    thresholds=DEFAULT_THRESHOLDS,
) -> Dict[str, float]:
    """Pairwise pose-AUC protocol (eval/pose_auc.py::evaluate_poses);
    unregistered images contribute inf."""
    from .eval.pose_auc import evaluate_poses

    est = {im.name: (im.qvec, im.tvec)
           for im in rec.images.values() if im.registered}
    out = evaluate_poses(est, gt_poses, thresholds)
    return {k: v for k, v in out.items() if k.startswith("auc@")}
