"""Command-line entry: reconstruct scenes, evaluate datasets, or train, on
the GPU.

Port of the JAX package's cli.py: the `reconstruct` and `eval-dataset`
verbs and the four training verbs, with every option of their parsers and
the same defaults, plus `--device` (default cuda; cpu is for tests) and,
on the training verbs, `--log-json PATH` (one JSON line per step: loss,
gradient norm, seconds). `--device cuda` takes every visible card, as JAX
takes every visible device (parallel/mesh.py): matching, refinement, BA
and the `train`/`train-matcher` steps shard over them; another value
(`cpu`, `cuda:1`) runs on that one device. Under a torch.distributed
group that the caller initialised (for example a `torchrun` wrapper that
calls `init_process_group` and then `main`), each process takes its own
card, `eval-dataset` strides scenes over the processes, `train` and
`train-matcher` shard scene indexes over them and sum their gradients
(every process steps the same weights and, as in JAX, writes the same
checkpoints and --log-json losses):

  python -m detectorfreesfm_tpu_torch.cli reconstruct --images DIR --output DIR
  python -m detectorfreesfm_tpu_torch.cli reconstruct --scene DIR --output DIR
  python -m detectorfreesfm_tpu_torch.cli reconstruct --scene DIR --output DIR \
      --triangulation --known-intrinsics --img-resize 1600
  python -m detectorfreesfm_tpu_torch.cli eval-dataset --dataset DIR --output DIR
  python -m detectorfreesfm_tpu_torch.cli train --data DIR --output DIR
  python -m detectorfreesfm_tpu_torch.cli train-matcher --data DIR --output DIR [--fine]
  python -m detectorfreesfm_tpu_torch.cli train-matcher-selfsup --images DIR --output CKPT
  python -m detectorfreesfm_tpu_torch.cli train-refiner-selfsup --images DIR --output CKPT

`train` and `train-matcher` read MegaDepth-style scene indexes (*.npz, see
data/megadepth.py) and write one checkpoint per epoch; the bootstraps
train on a folder of images. Checkpoints are flax msgpack files that
both packages' loaders read.

Scene layout (reference tools/parse_data contract): the scene dir holds
images/ [+ poses/{img}.txt 4x4 w2c] [+ intrins/{img}.txt 3x3 K]. The
result is one JSON line, with pose AUCs when poses are given. Beyond the
JAX verb's keys it says how refinement ended (`refine_iterations_completed`,
`refine_error`); where a fault of the card stopped refinement, the status
is "refine_failed" and the exit code 1, though the models are written.

`--triangulation` (with --scene) keeps the scene's poses/ fixed and only
triangulates and refines structure: the ETH3D protocol, at --img-resize
1600, where `--fused auto` takes the fused dual-softmax kernels.
`eval-dataset` runs every scene dir of --dataset (each holding images/),
prints one JSON line per scene and writes the aggregated metrics.txt
(pose AUCs and the registered ratio, per IMC bag with --imc-bags);
--isolate-scenes runs each scene in a subprocess of the `reconstruct`
verb, with one resuming retry after a crash or a --scene-timeout.
`reconstruct --trace-dir DIR` runs the verb inside utils.profiler's
`trace_to(DIR)`: a Chrome trace of the host and the card, and spans.json
beside it.

`--dtype bfloat16` (reconstruct, eval-dataset) runs the matcher in bf16,
and `--dtype-train bfloat16` (train-matcher, train-matcher-selfsup) trains
it in bf16 on fp32 parameters, as the JAX verbs do; float32 is the
default, and refinement stays float32 (models/loftr.py).

`--matcher-arch aspan|matchformer|efficientloftr --matcher-ckpt CKPT`
(reconstruct, eval-dataset) matches with another family of
models.build_matcher, dense whatever --fused says, as in JAX (every
family computes its views once per engine call, match/engine.py;
MatchFormer's encoder attends across the two images, so its views are its
frames); these families have no bundled default
(weights/demo_aspan_bf16.msgpack is an ASpan checkpoint), so the
checkpoint must be named. EfficientLoFTR (models/efficientloftr.py, the
port alone: no JAX counterpart) runs in float32 only and always refines
both keypoints with its own fine stage, whatever --match-type says; its
published weights load once converted with
models.efficientloftr.from_published. `train-matcher --arch
aspan|matchformer` trains ASpan and MatchFormer with the coarse focal
loss, from a fresh init or --init-ckpt.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_scene_gt(scene_dir: str):
    poses_dir = os.path.join(scene_dir, "poses")
    intrin_dir = os.path.join(scene_dir, "intrins")
    poses = None
    intrins = None
    if os.path.isdir(poses_dir):
        from .pipeline import read_pose_txt

        poses = {}
        for f in sorted(os.listdir(poses_dir)):
            if f.endswith(".txt"):
                name = os.path.splitext(f)[0]
                poses[name] = read_pose_txt(os.path.join(poses_dir, f))
    if os.path.isdir(intrin_dir):
        from .pipeline import read_intrin_txt

        intrins = {}
        for f in sorted(os.listdir(intrin_dir)):
            if f.endswith(".txt"):
                name = os.path.splitext(f)[0]
                intrins[name] = read_intrin_txt(os.path.join(intrin_dir, f))
    return poses, intrins


def _match_gt_names(gt: dict, image_names) -> dict:
    """GT files are keyed by stem; remap to actual image filenames."""
    if gt is None:
        return None
    stem = {os.path.splitext(n)[0]: n for n in image_names}
    out = {}
    for k, v in gt.items():
        if k in stem:
            out[stem[k]] = v
        elif k in image_names:
            out[k] = v
    return out or None


def _bundled_weight(name: str):
    """Path to a bundled checkpoint under <repo>/weights, or None."""
    p = os.path.join(os.path.dirname(__file__), "..", "weights", name)
    return os.path.abspath(p) if os.path.exists(p) else None


def _run_scene(args) -> dict:
    from .device import resolve_device
    from .models import LOFTR_FAMILY
    from .pipeline import (
        PipelineConfig,
        evaluate_scene_poses,
        list_scene_images,
        matches_stored,
        reconstruct_scene,
    )
    from .refine.loop import RefineConfig
    from .sfm.mapper import MapperConfig

    dev = resolve_device(args.device)
    scene = args.scene or args.images
    image_dir = args.images or os.path.join(scene, "images")
    names = list_scene_images(image_dir, args.n_images)
    poses, intrins = _load_scene_gt(scene) if args.scene else (None, None)
    poses = _match_gt_names(poses, names)
    intrins = _match_gt_names(intrins, names)

    refine_kw = {}
    if getattr(args, "refine_windows", None):
        refine_kw["windows"] = tuple(
            int(w) for w in args.refine_windows.split(","))
    if getattr(args, "refine_thresholds", None):
        refine_kw["filter_thresholds"] = tuple(
            float(t) for t in args.refine_thresholds.split(","))
    if getattr(args, "reregister_every", None):
        refine_kw["reregister_every"] = args.reregister_every
    fused = getattr(args, "fused", "auto")
    if fused == "auto":
        # The fused kernels never materialise the (L, S) score matrix: the
        # path for large frames. At <= 832 px the dense matrix fits and
        # stays the default. Auto picks dense up to 12k coarse tokens
        # (~880 px) and the kernels above, on the card only.
        n_tokens = (args.img_resize // 8) ** 2
        fused = dev.type == "cuda" and n_tokens > 12000
    else:
        fused = fused == "on"
    bs = getattr(args, "match_batch_size", None)
    if bs is None:
        bs = 8 if dev.type == "cuda" else 1
    arch = getattr(args, "matcher_arch", "loftr")
    cfg = PipelineConfig(
        matcher=arch,
        img_resize=args.img_resize,
        match_threshold=args.match_threshold,
        match_type=getattr(args, "match_type", "coarse_only"),
        round_matches_ratio=getattr(args, "round_matches_ratio", None),
        fused_matching=fused,
        batch_size=bs,
        n_refine_iters=args.refine_iters,
        refine=RefineConfig(**refine_kw),
        triangulation_mode=args.triangulation,
        pair_mode=args.pair_mode,
        n_images=args.n_images,
        redo_matching=args.redo,
        redo_sfm=args.redo,
        redo_refine=args.redo,
        compute_dtype=args.dtype,
        mapper=MapperConfig(
            camera_model=getattr(args, "camera_model",
                                 "pinhole").upper(),
            # Known GT intrinsics stay fixed in BA; focal refinement
            # only makes sense when focals were guessed.
            # --known-intrinsics forces fixed.
            refine_focal=(intrins is None) and not args.known_intrinsics,
            min_model_size=args.min_model_size,
            abs_pose_min_num_inliers=args.min_inliers,
            min_tri_angle_deg=args.min_tri_angle,
        ),
    )

    matcher_params = None
    need_matching = args.redo or not matches_stored(args.output)
    matcher_ckpt = getattr(args, "matcher_ckpt", None)
    if need_matching and matcher_ckpt is None:
        if arch not in LOFTR_FAMILY:
            raise SystemExit(
                "--matcher-arch %s needs an explicit --matcher-ckpt "
                "(bundled defaults are LoFTR-family)." % arch)
        # A bare `cli reconstruct` must never match with random weights:
        # resolve the bundled matcher or refuse. Cached-match runs skip
        # the load entirely.
        matcher_ckpt = _bundled_weight("demo_matcher_r5_bf16.msgpack")
        if matcher_ckpt is None:
            raise SystemExit(
                "matching needs trained weights: pass --matcher-ckpt "
                "<ckpt.msgpack> (no bundled default found under weights/)."
            )
        print(f"using bundled matcher weights: {matcher_ckpt}",
              file=sys.stderr)
    if matcher_ckpt and arch in LOFTR_FAMILY:
        from .utils.checkpoint import load_matcher_params

        # The load template must match the engine's parameters: with
        # --match-type coarse_fine the checkpoint's fine head is loaded.
        matcher_params = load_matcher_params(
            matcher_ckpt, cfg=cfg.engine_config().matcher_config())
    elif matcher_ckpt:
        from .utils.checkpoint import load_arch_params

        # ASpan / MatchFormer / EfficientLoFTR: the file held strictly to
        # the arch's model.
        matcher_params = load_arch_params(matcher_ckpt, arch)
    refiner_params = None
    refiner_ckpt = getattr(args, "refiner_ckpt", None)
    if refiner_ckpt is None and args.refine_iters > 0:
        # Refinement with random weights only perturbs keypoints: refuse
        # unless the bundled default checkpoint exists.
        refiner_ckpt = _bundled_weight("demo_refiner_r4_bf16.msgpack")
        if refiner_ckpt is None:
            raise SystemExit(
                "--refine-iters > 0 needs trained refiner weights: pass "
                "--refiner-ckpt <ckpt.msgpack> (no bundled default found "
                "under weights/), or set --refine-iters 0."
            )
        print(f"using bundled refiner weights: {refiner_ckpt}",
              file=sys.stderr)
    if refiner_ckpt:
        from .utils.checkpoint import load_refiner_params

        refiner_params = load_refiner_params(refiner_ckpt, device=dev)
    info: dict = {}
    rec = reconstruct_scene(
        image_dir, args.output, cfg,
        intrinsics=intrins,
        poses=poses if args.triangulation else None,
        matcher_params=matcher_params,
        refiner_params=refiner_params,
        verbose=args.verbose,
        device=dev,
        info=info,
    )
    if rec is None:
        return {"status": "failed"}
    result = {
        # A data-dependent refinement failure keeps the last good model,
        # as the JAX verb does; a fault of the card is not a result.
        "status": "refine_failed" if info["refine_device_error"] else "ok",
        "n_registered": len(rec.registered_images),
        "n_images": len(rec.images),
        "n_points": len(rec.points),
        "n_observations": rec.n_observations(),
        "refine_iterations_completed": info["refine_iterations_completed"],
        "refine_error": info["refine_error"],
    }
    if poses:
        result["pose_auc"] = evaluate_scene_poses(rec, poses)
    return result


def cmd_reconstruct(args) -> int:
    trace_dir = getattr(args, "trace_dir", None)
    if trace_dir:
        from .utils.profiler import trace_to

        with trace_to(trace_dir):
            result = _run_scene(args)
    else:
        result = _run_scene(args)
    print(json.dumps(result))
    return 0 if result.get("status") == "ok" else 1


def _run_isolated(ns, scene: str, timeout_s: int) -> dict:
    """One scene of eval-dataset in a subprocess of the `reconstruct` verb,
    so that a native crash or a fault of the card ends only that scene.
    The full option namespace goes to <output>/_scene_args.json (a value
    that is not JSON raises), so the child runs exactly the parent's
    configuration. A timeout or a crash is retried once, and the retry
    resumes from the stage artifacts; a clean result line, even
    status=failed, is final."""
    import subprocess

    payload = {}
    for k, v in vars(ns).items():
        if k in ("fn", "isolate_scenes", "args_json"):
            continue
        try:
            json.dumps(v)
        except TypeError:
            raise SystemExit(
                f"--isolate-scenes cannot serialize option {k}={v!r} for "
                f"the child process") from None
        payload[k] = v
    os.makedirs(ns.output, exist_ok=True)
    args_path = os.path.join(ns.output, "_scene_args.json")
    with open(args_path, "w") as f:
        json.dump(payload, f, indent=1)
    cmd = [sys.executable, "-m", "detectorfreesfm_tpu_torch.cli",
           "reconstruct", "--output", ns.output, "--args-json", args_path]
    # The child imports this checkout's package wherever it is started.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    last_err = None
    for attempt in range(2):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=timeout_s, env=env)
        except subprocess.TimeoutExpired:
            last_err = f"timeout after {timeout_s}s"
            print(f"scene {scene}: {last_err} (attempt {attempt})",
                  file=sys.stderr)
            continue
        try:
            return json.loads(out.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            pass
        last_err = out.stderr[-500:] or f"rc={out.returncode}"
        if out.returncode != 0:
            print(f"scene {scene}: crashed attempt {attempt}",
                  file=sys.stderr)
    return {"status": "failed", "error": last_err}


def cmd_eval_dataset(args) -> int:
    """Every scene of a dataset, and the aggregated metrics.txt (with IMC
    bag grouping under --imc-bags)."""
    from .device import resolve_device
    from .parallel.orchestrate import run_eval_scenes

    # A missing card fails the run here, not each scene in the isolation
    # that turns a scene's exception into a failed scene.
    resolve_device(args.device)
    scenes = sorted(
        d for d in os.listdir(args.dataset)
        if os.path.isdir(os.path.join(args.dataset, d, "images"))
    )
    if args.scene_list:
        wanted = set(args.scene_list.split(","))
        scenes = [s for s in scenes if s in wanted]
    if args.exclude_scenes:
        banned = set(args.exclude_scenes.split(","))
        scenes = [s for s in scenes if s not in banned]
    if args.n_scenes:
        scenes = scenes[: args.n_scenes]

    def scene_fn(s):
        ns = argparse.Namespace(**vars(args))
        ns.scene = os.path.join(args.dataset, s)
        ns.images = None
        ns.output = os.path.join(args.output, s)
        if args.isolate_scenes:
            return _run_isolated(ns, s, args.scene_timeout or 7200)
        return _run_scene(ns)

    # Scenes stride over the processes of an initialised torch.distributed
    # group (one process otherwise); process 0 writes metrics.txt.
    run_eval_scenes(scenes, scene_fn, args.output, imc_bags=args.imc_bags,
                    title=os.path.basename(args.dataset))
    return 0


def _datasets(args):
    """The scene indexes of --data, sharded over the processes of an
    initialised torch.distributed group (one process otherwise)."""
    import glob

    from .data.megadepth import (MegaDepthTupleDataset, SceneBalancedSampler,
                                 load_scene_index, shard_scenes)

    from .parallel.orchestrate import process_rank_count

    scene_files = sorted(glob.glob(os.path.join(args.data, "*.npz")))
    if not scene_files:
        return None, None, 1
    rank, world = process_rank_count()
    scene_files = shard_scenes(scene_files, rank, world)
    datasets = [MegaDepthTupleDataset(load_scene_index(p),
                                      img_size=args.img_resize)
                for p in scene_files]
    sampler = SceneBalancedSampler([len(d) for d in datasets],
                                   n_per_scene=args.samples_per_scene)
    return datasets, sampler, world


def _train_loop(args, trainer, datasets, sampler, make_batch, step_args,
                ckpt_name):
    """The JAX verbs' epoch loop: batches in sampler order, --init-ckpt
    after the first batch's init, a checkpoint per epoch, --max-steps."""
    import time

    from .train.trainer import StepLog

    log = StepLog(args.log_json)
    state = None
    step = 0
    max_steps = args.max_steps
    ep0 = args.start_epoch
    for epoch in range(ep0, ep0 + args.epochs):
        ids = sampler.epoch(epoch).tolist()
        bs = max(1, args.batch_size)
        for start in range(0, len(ids) - bs + 1, bs):
            batch = make_batch([datasets[s][t]
                                for s, t in ids[start:start + bs]])
            if state is None:
                state = trainer.init_state(batch)
                if args.init_ckpt:
                    state = state._replace(params=trainer.load_params(
                        args.init_ckpt, state.params))
            t0 = time.time()
            state, loss = trainer.train_step(state, batch, *step_args(step))
            log(step, float(loss), trainer.history[-1]["grad_norm"], t0)
            step += 1
            if step % args.log_every == 0:
                print(f"epoch {epoch} step {step} loss {float(loss):.5f}",
                      flush=True)
            if max_steps and step >= max_steps:
                break
        if state is not None:
            trainer.save_checkpoint(state, os.path.join(
                args.output, ckpt_name.format(epoch=epoch)))
        if max_steps and step >= max_steps:
            break
    return 0


def cmd_train(args) -> int:
    """Train the multiview refiner on MegaDepth-style scene indexes."""
    from .data.megadepth import collate
    from .models.multiview_matcher import RefinerConfig
    from .train.optimizers import OptimConfig
    from .train.trainer import TrainConfig, Trainer
    from .utils import prng

    datasets, sampler, world = _datasets(args)
    if datasets is None:
        print("no scene index files found", file=sys.stderr)
        return 1
    cfg = TrainConfig(
        refiner=RefinerConfig(crop_size=args.window + 4, window=args.window),
        optim=OptimConfig(true_batch_size=args.batch_size * world),
        n_tracks=args.n_tracks)
    trainer = Trainer(cfg, device=args.device)
    rng = prng.PRNGKey(cfg.seed)
    return _train_loop(args, trainer, datasets, sampler, collate,
                       lambda step: (prng.fold_in(rng, step),),
                       "ckpt_ep{epoch}.msgpack")


def cmd_train_matcher(args) -> int:
    """Train the detector-free matcher (coarse, or with --fine the fine
    stage too) on depth-warped cell labels."""
    from .models.loftr import MatcherConfig
    from .train.matcher_trainer import (MatcherTrainConfig, MatcherTrainer,
                                        tuple_to_pair_batch)
    from .train.optimizers import OptimConfig

    datasets, sampler, world = _datasets(args)
    if datasets is None:
        print("no scene index files found", file=sys.stderr)
        return 1
    cfg = MatcherTrainConfig(
        arch=args.arch,
        matcher=MatcherConfig(compute_dtype=args.dtype_train,
                              fine_enabled=bool(args.fine)),
        optim=OptimConfig(true_batch_size=args.batch_size * world,
                          backbone_path="backbone"))
    try:
        trainer = MatcherTrainer(cfg, device=args.device)
    except ValueError as e:  # --fine with a matcher that has no fine stage
        raise SystemExit(str(e)) from None
    return _train_loop(args, trainer, datasets, sampler, tuple_to_pair_batch,
                       lambda step: (), "matcher_ep{epoch}.msgpack")


def cmd_train_matcher_selfsup(args) -> int:
    from .models.loftr import MatcherConfig
    from .train.selfsup import train_matcher_selfsup
    from .utils.checkpoint import load_matcher_params

    init = None
    if args.init_ckpt:
        init = load_matcher_params(
            args.init_ckpt, cfg=MatcherConfig(compute_dtype=args.dtype_train))
    train_matcher_selfsup(
        args.images, args.output, steps=args.steps, img_size=args.img_resize,
        batch=args.batch_size, lr=args.lr, log_every=args.log_every,
        compute_dtype=args.dtype_train, init_params=init, device=args.device,
        log_json=args.log_json)
    return 0


def cmd_train_refiner_selfsup(args) -> int:
    from .train.refiner_selfsup import train_refiner_selfsup

    train_refiner_selfsup(
        args.images, args.output, steps=args.steps, img_size=args.img_resize,
        n_views=args.n_views, n_tracks=args.n_tracks, lr=args.lr,
        log_every=args.log_every, device=args.device, log_json=args.log_json)
    return 0


def _add_train_io(sp):
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda: every visible card, "
                         "which must be present)")
    sp.add_argument("--log-json", default=None, dest="log_json",
                    help="write one JSON line per step (loss, gradient "
                         "norm, seconds) to this file")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="detectorfreesfm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp):
        sp.add_argument("--output", required=True)
        sp.add_argument("--img-resize", type=int, default=832,
                        dest="img_resize")
        sp.add_argument("--match-type", default="coarse_fine",
                        choices=("coarse_only", "coarse_fine"),
                        dest="match_type",
                        help="coarse_fine (default) runs the sub-pixel fine "
                             "stage and rounds matches to a 4px grid (the "
                             "reference's TexturePoorSfM protocol; needs a "
                             "checkpoint trained with --fine)")
        sp.add_argument("--round-matches-ratio", type=int, default=None,
                        dest="round_matches_ratio",
                        help="quantize match coords to an N-px grid before "
                             "keypoint merge (reference round_matches_ratio)")
        sp.add_argument("--match-batch-size", type=int, default=None,
                        dest="match_batch_size",
                        help="pairs per matching step (default: 8 on the "
                             "GPU, 1 on the CPU)")
        sp.add_argument("--fused", default="auto",
                        choices=("auto", "on", "off"),
                        help="fused dual-softmax kernels (auto: on the GPU "
                             "above 12000 coarse tokens, i.e. above ~880 px)")
        sp.add_argument("--match-threshold", type=float, default=0.2,
                        dest="match_threshold")
        sp.add_argument("--refine-iters", type=int, default=2,
                        dest="refine_iters")
        sp.add_argument("--refine-windows", default=None,
                        dest="refine_windows",
                        help="comma list of per-iteration attention windows,"
                             " e.g. 15,11,7,7")
        sp.add_argument("--refine-thresholds", default=None,
                        dest="refine_thresholds",
                        help="comma list of per-iteration filter thresholds"
                             " (px), e.g. 6,4,3,2.5")
        sp.add_argument("--reregister-every", type=int, default=None,
                        dest="reregister_every",
                        help="attempt re-registration every N refine iters")
        sp.add_argument("--triangulation", action="store_true",
                        help="known-pose triangulation: the scene's poses/ "
                             "stay fixed, only structure is estimated and "
                             "refined (needs --scene)")
        sp.add_argument("--pair-mode", default="exhaustive",
                        dest="pair_mode",
                        choices=["exhaustive", "sequential"])
        sp.add_argument("--n-images", type=int, default=None,
                        dest="n_images")
        sp.add_argument("--min-model-size", type=int, default=3,
                        dest="min_model_size")
        sp.add_argument("--camera-model", default="pinhole",
                        choices=("pinhole", "simple_pinhole",
                                 "simple_radial"),
                        dest="camera_model",
                        help="camera model for reconstruction; simple_radial"
                             " estimates a k1 radial coefficient in BA (the"
                             " reference's ETH3D default)")
        sp.add_argument("--known-intrinsics", action="store_true",
                        dest="known_intrinsics")
        sp.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="matcher compute dtype (refinement stays "
                             "float32, as in JAX)")
        sp.add_argument("--redo", action="store_true")
        sp.add_argument("--verbose", action="store_true")
        sp.add_argument("--matcher-ckpt", default=None, dest="matcher_ckpt",
                        help="trained matcher checkpoint (.msgpack)")
        sp.add_argument("--matcher-arch", default="loftr",
                        dest="matcher_arch",
                        choices=["loftr", "aspan", "matchformer",
                                 "efficientloftr"],
                        help="matcher architecture family (alt archs need "
                             "an explicit --matcher-ckpt; efficientloftr "
                             "runs in float32 only)")
        sp.add_argument("--refiner-ckpt", default=None, dest="refiner_ckpt",
                        help="trained refiner checkpoint (.msgpack)")
        sp.add_argument("--min-inliers", type=int, default=30,
                        dest="min_inliers",
                        help="PnP registration inlier floor (reference"
                             " abs_pose_min_num_inliers)")
        sp.add_argument("--min-tri-angle", type=float, default=1.5,
                        dest="min_tri_angle",
                        help="point filter triangulation-angle floor in"
                             " degrees (COLMAP Mapper.filter_min_tri_angle;"
                             " lower to 1.0 on small wide-baseline scenes)")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda: every visible "
                             "card, which must be present; cpu runs the "
                             "plain versions of the kernels)")

    sr = sub.add_parser("reconstruct", help="reconstruct one scene")
    sr.add_argument("--images", default=None, help="image directory")
    sr.add_argument("--scene", default=None,
                    help="scene dir with images/ [poses/ intrins/]")
    sr.add_argument("--args-json", default=None, dest="args_json",
                    help="load the FULL option namespace from a JSON file")
    sr.add_argument("--trace-dir", default=None, dest="trace_dir",
                    help="run the verb under torch.profiler: a Chrome trace "
                         "and spans.json (the program's spans and counters)"
                         " into DIR")
    add_common(sr)
    sr.set_defaults(fn=cmd_reconstruct)

    se = sub.add_parser("eval-dataset", help="reconstruct + eval all scenes")
    se.add_argument("--dataset", required=True)
    se.add_argument("--n-scenes", type=int, default=None, dest="n_scenes")
    se.add_argument("--scene-list", default=None, dest="scene_list",
                    help="comma-separated scene names to include")
    se.add_argument("--exclude-scenes", default=None, dest="exclude_scenes")
    se.add_argument("--isolate-scenes", action="store_true",
                    dest="isolate_scenes",
                    help="run each scene in a subprocess so native crashes"
                         " or faults of the card kill only that scene")
    se.add_argument("--scene-timeout", type=int, default=None,
                    dest="scene_timeout",
                    help="per-scene wall limit (s) for --isolate-scenes; "
                         "a timed-out or crashed scene is retried ONCE, "
                         "resuming from its persisted stage artifacts. "
                         "Default 7200.")
    se.add_argument("--imc-bags", action="store_true", dest="imc_bags",
                    help="group metrics by IMC Nbag markers in scene names")
    add_common(se)
    se.set_defaults(fn=cmd_eval_dataset)

    st = sub.add_parser("train", help="train the multiview refiner")
    st.add_argument("--data", required=True, help="dir of scene .npz indexes")
    st.add_argument("--output", required=True)
    st.add_argument("--epochs", type=int, default=25)
    st.add_argument("--batch-size", type=int, default=1, dest="batch_size")
    st.add_argument("--img-resize", type=int, default=832, dest="img_resize")
    st.add_argument("--samples-per-scene", type=int, default=250,
                    dest="samples_per_scene")
    st.add_argument("--log-every", type=int, default=50, dest="log_every")
    st.add_argument("--n-tracks", type=int, default=200, dest="n_tracks")
    st.add_argument("--window", type=int, default=15)
    st.add_argument("--init-ckpt", default=None, dest="init_ckpt",
                    help="warm-start from a previous checkpoint")
    st.add_argument("--max-steps", type=int, default=None, dest="max_steps")
    st.add_argument("--start-epoch", type=int, default=0, dest="start_epoch",
                    help="first epoch number (sampler RNG; lets one-epoch-"
                         "per-process runs chain via --init-ckpt)")
    _add_train_io(st)
    st.set_defaults(fn=cmd_train)

    sm = sub.add_parser("train-matcher", help="train the coarse matcher")
    sm.add_argument("--data", required=True, help="dir of scene .npz indexes")
    sm.add_argument("--output", required=True)
    sm.add_argument("--epochs", type=int, default=30)
    sm.add_argument("--batch-size", type=int, default=1, dest="batch_size")
    sm.add_argument("--img-resize", type=int, default=832, dest="img_resize")
    sm.add_argument("--samples-per-scene", type=int, default=200,
                    dest="samples_per_scene")
    sm.add_argument("--log-every", type=int, default=50, dest="log_every")
    sm.add_argument("--dtype-train", default="float32", dest="dtype_train",
                    choices=["float32", "bfloat16"],
                    help="the matcher's compute dtype while training "
                         "(parameters and optimizer stay float32)")
    sm.add_argument("--init-ckpt", default=None, dest="init_ckpt",
                    help="warm-start from a previous checkpoint")
    sm.add_argument("--max-steps", type=int, default=None, dest="max_steps")
    sm.add_argument("--start-epoch", type=int, default=0, dest="start_epoch",
                    help="first epoch number (controls the sampler's epoch"
                         " RNG; lets one-epoch-per-process runs chain via"
                         " --init-ckpt without repeating samples)")
    sm.add_argument("--fine", action="store_true",
                    help="jointly train the fine sub-pixel stage "
                         "(teacher-forced at GT coarse cells; needed for "
                         "--match-type coarse_fine at inference)")
    sm.add_argument("--arch", default="loftr",
                    choices=["loftr", "aspan", "matchformer"],
                    help="matcher family to train")
    _add_train_io(sm)
    sm.set_defaults(fn=cmd_train_matcher)

    ss = sub.add_parser("train-matcher-selfsup",
                        help="homography self-supervised matcher bootstrap")
    ss.add_argument("--images", required=True)
    ss.add_argument("--output", required=True, help="checkpoint .msgpack path")
    ss.add_argument("--steps", type=int, default=1000)
    ss.add_argument("--batch-size", type=int, default=4, dest="batch_size")
    ss.add_argument("--img-resize", type=int, default=416, dest="img_resize")
    ss.add_argument("--lr", type=float, default=1e-3)
    ss.add_argument("--log-every", type=int, default=50, dest="log_every")
    ss.add_argument("--dtype-train", default="float32", dest="dtype_train",
                    choices=["float32", "bfloat16"],
                    help="the matcher's compute dtype while training "
                         "(parameters and optimizer stay float32)")
    ss.add_argument("--init-ckpt", default=None, dest="init_ckpt",
                    help="warm-start from a previous checkpoint")
    _add_train_io(ss)
    ss.set_defaults(fn=cmd_train_matcher_selfsup)

    sf = sub.add_parser("train-refiner-selfsup",
                        help="homography self-supervised refiner bootstrap")
    sf.add_argument("--images", required=True)
    sf.add_argument("--output", required=True)
    sf.add_argument("--steps", type=int, default=1000)
    sf.add_argument("--img-resize", type=int, default=256, dest="img_resize")
    sf.add_argument("--n-views", type=int, default=4, dest="n_views")
    sf.add_argument("--n-tracks", type=int, default=128, dest="n_tracks")
    sf.add_argument("--lr", type=float, default=1e-3)
    sf.add_argument("--log-every", type=int, default=50, dest="log_every")
    _add_train_io(sf)
    sf.set_defaults(fn=cmd_train_refiner_selfsup)

    args = p.parse_args(argv)
    if getattr(args, "args_json", None):
        with open(args.args_json) as f:
            for k, v in json.load(f).items():
                setattr(args, k, v)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
