#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (detectorfreesfm_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout; imports only the
standard library, numpy, torch and the port. Phases, one JSON line each:

  device   card name and power limit
  build    nvcc of the port's CUDA sources into build/torch_kernels/, and
           the count of tensor-core (HGMMA) instructions in the library
  kernels  each kernel against its plain torch version at a ragged shape,
           the main path's (B=2, L=S=10816, C=256) and the 1600 px one
           (B=1, L=S=40000), timed at the last two; planted ties across
           row and column tiles resolve to the first index
  weights  the bundled r5 matcher through the port's converter
  main     6 exhaustive pairs of a 832 px synthetic scene, coarse_fine,
           through PairMatchingEngine with the fused kernels, held to the
           dense path and to the JAX engine's recorded numbers
  geometry the slice beneath the mapper on the card, from main's fused
           matches and on the 28 cached pairs of tests/data/torch/
           demo_cached_832: match store (h5io), essential/homography
           RANSAC, native track builder, DLT triangulation, PnP +
           refine_pose, bundle adjustment at 4, 60 and 250 cameras, model
           store (colmap_io, database, model_select); held to the JAX
           package's numbers recorded with
           `python tests/test_torch_sfm.py --record`, with card times per
           step
  sfm      the incremental mapper on the card, on main's matches with and
           without the true intrinsics and on the cached demo_cached_832
           and demo_cached matches, then two refinement iterations
           (S2DNet + MultiviewRefiner, r4 weights) of the known-intrinsics
           model on main's images; held to the JAX package's numbers
           recorded with `python tests/test_torch_mapper.py --record`, with
           the mapper's seconds per step and the refiner's device ms per
           chunk; full report in build/smoke_sfm/sfm.json
  reconstruct
           `detectorfreesfm_tpu_torch.cli reconstruct` on a 4-view 1040 px
           scene written as PNG files (run A, --fused on, every other
           option at its default: r5 matcher at 832 px, coarse_fine, batch
           8, mapper, two refinement iterations with the r4 refiner), held
           to the JAX package's own CLI on the same files (recorded with
           `python tests/test_torch_pipeline.py --record`); run B, the
           same command in a subprocess, resumes without matching; run C,
           6 views (15 pairs), must complete; fused against dense
           matching at 832 px; full report in
           build/smoke_reconstruct/reconstruct.json
  train    the four training verbs through the port's cli.main on two
           rendered 832 px scenes written to disk (6 views, tuples of 4):
           `train-matcher --fine` (r5 warm start), `train` (r4 warm start,
           200 tracks, window 15), `train-matcher-selfsup` (r5, 416 px,
           batch 4) and `train-refiner-selfsup` (fresh init, 256 px), 3
           steps each; every step's loss and gradient norm held to the
           JAX package's on the same files (JAX_TRAIN, recorded with
           `python tests/test_torch_train.py --record`), checkpoints read
           back strictly, the fused kernels launched 0 times while
           training, the trained matcher served through them; step times,
           peak memory and a torch.profiler breakdown of one steady
           train-matcher step; full report in build/smoke_train/train.json
  eval     `detectorfreesfm_tpu_torch.cli eval-dataset --triangulation
           --known-intrinsics --imc-bags` on two 4-view scenes written as
           PNG at 2000 px (E1: the verb's defaults, 832 px, dense), held
           to the JAX package's own eval-dataset on the same files
           (recorded with `python tests/test_torch_eval_dataset.py
           --record`): models, poses equal to poses/, metrics.txt; E2, the
           same command with --isolate-scenes, resumes every scene in a
           subprocess; E3, the first scene with `reconstruct
           --triangulation --img-resize 1600` through both kernels (one
           launch each per batch of 8 pairs), its stage times and peak
           memory, fused against dense at 1600 px on one pair, and the
           ETH3D accuracy/completeness of the 832 and 1600 px models
           against the scene's true surface; both passes at 1600 px,
           B = 8; full report in build/smoke_eval/eval.json
  bf16     the JAX package's bf16 compute path, on the files the
           reconstruct and train phases wrote: both passes against their
           plain versions on features rounded to bf16 (B = 8, 832 px);
           main's 6 pairs with the matcher in bf16 (fused against dense
           at IoU >= 0.95, valid matches and median epipolar error held
           to the JAX engine's bf16 numbers, 3 launches of each pass);
           run A with `--dtype bfloat16` held to the JAX CLI's own bf16
           run on the same files (JAX_RECONSTRUCT_BF16, `python
           tests/test_torch_pipeline.py --record --dtype bfloat16`) with
           run A's gates; `train-matcher --fine` and
           `train-matcher-selfsup` with `--dtype-train bfloat16`, 3 steps
           each, their losses and gradient norms held to JAX's bf16
           steps (JAX_TRAIN_BF16, `python tests/test_torch_train.py
           --record --dtype bfloat16`): step 0 within twice JAX's own
           bf16-fp32 gap, steps 1-2 as one vector within that gap in
           relative norm (see _check_train_bf16), fp32 checkpoints read
           back, 0 launches; reported: warm
           pairs/s, device ms by kernel and training peak memory in bf16
           beside fp32's; full report in build/smoke_bf16/bf16.json

The build phase also builds the native image loader (g++, -ljpeg -lpng)
and says whether it linked. Any failed check raises (non-zero exit). The
last two lines are the kernels summary and {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(REPO, "weights", "demo_matcher_r5_bf16.msgpack")

# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 on the tensor
# cores and HBM3 bandwidth. The kernels run three bf16 products (hi/lo
# halves) on the tensor cores.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# The dense JAX engine on the CPU, same scene and settings, by compute
# dtype: (valid matches, median epipolar error in px), recorded with
# `python tests/test_torch_engine.py --size 832 [--dtype bfloat16]`
# (PERF.md). 12 288 is 2048 (the top-K capacity) on each pair.
JAX_MAIN = {"float32": (12288, 1.0242514909205727),
            "bfloat16": (12288, 1.0236274885146541)}

MAIN_SHAPE = dict(b=2, l=10816, s=10816, c=256)
# The verb's batch of 8 pairs at 832 px, the shape that the reconstruct
# phase's runs launch and that the `kernels` line reports.
VERB_SHAPE = dict(b=8, l=10816, s=10816, c=256)
RAGGED_SHAPE = dict(b=2, l=1000, s=777, c=256)
ETH3D_SHAPE = dict(b=1, l=40000, s=40000, c=256)  # 1600 px, one pair
# Device kernels of csrc/dual_softmax.cu, as the profiler names them.
DSM_KERNELS = ("pass1_kernel", "pass2_kernel", "combine1_kernel",
               "combine2_kernel")
N_PARAMS_R5 = 11265288


def check(ok, *what):
    """A check of the run; raises (not an assert, which -O would drop)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    """Mean device ms of fn() over iters launches, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def iou(a, b):
    return len(a & b) / max(len(a | b), 1)


def match_set(m, b):
    v = m.valid[b].cpu().numpy()
    return set(zip(m.idx0[b].cpu().numpy()[v].tolist(),
                   m.idx1[b].cpu().numpy()[v].tolist()))


def row_set(m):
    return {tuple(r) for r in np.concatenate([m["kpts0"], m["kpts1"]],
                                             1).tolist()}


def features(b, l, s, c, seed):
    """Features with post-transformer statistics of the r5 matcher (token
    norm ~42 with a large shared component, logits ~5..70), and planted
    mutual matches."""
    from detectorfreesfm_tpu_torch.ops.dual_softmax import border_mask

    rng = np.random.default_rng(seed)
    common = rng.normal(0, 1, c)
    common *= 30.0 / np.linalg.norm(common)
    f0 = common + rng.normal(0, 1.8, (b, l, c))
    f1 = common + rng.normal(0, 1.8, (b, s, c))
    n = min(1200, min(l, s) // 3)  # below K, so no ties at the top-K cut
    for i in range(b):
        src = rng.choice(l, n, replace=False)
        dst = rng.choice(s, n, replace=False)
        f1[i, dst] = f0[i, src] + rng.normal(0, 0.6, (n, c))
    side = int(round(l ** 0.5))
    if side * side == l and l == s:
        m0 = border_mask(side, side, 2)[None].expand(b, -1).clone()
        m1 = m0.clone()
    else:
        m0 = torch.from_numpy(rng.uniform(size=(b, l)) > 0.05)
        m1 = torch.from_numpy(rng.uniform(size=(b, s)) > 0.05)
    dev = torch.device("cuda")
    return (torch.tensor(f0, dtype=torch.float32, device=dev),
            torch.tensor(f1, dtype=torch.float32, device=dev),
            m0.to(dev), m1.to(dev))


def bound(shape, pass2):
    """(bound ms, bound_by) of one pass: three bf16 products on the tensor
    cores against its bytes (each input read once, each output written
    once): the four feature halves, the masks, pass 2's lse inputs, and
    the outputs (two lse vectors; or a max and an arg per row and column)."""
    b, l, s, c = shape["b"], shape["l"], shape["s"], shape["c"]
    flops = 3 * 2.0 * b * l * s * c
    vec = 4.0 * b * (l + s)
    nbytes = 2 * 2.0 * b * (l + s) * c + vec + (3 * vec if pass2 else vec)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check_kernels(shape, seed, timed, bf16=False):
    """Both passes against their plain versions on features(seed, shape),
    or with bf16=True on those features rounded to bf16, as the bf16
    matcher hands them over (split_features upcasts; lo1 is then 0)."""
    from detectorfreesfm_tpu_torch.ops import fused_dsm as K

    f0, f1, m0, m1 = features(seed=seed, **shape)
    if bf16:
        f0, f1 = f0.bfloat16(), f1.bfloat16()
    ops = K.split_features(f0, f1, m0, m1, 0.1)
    out = {}

    lse_r, lse_c = K.dsm_pass1(*ops)
    ref_r, ref_c = K.dsm_pass1_plain(*ops)
    err_lse = max((lse_r - ref_r)[m0].abs().max().item(),
                  (lse_c - ref_c)[m1].abs().max().item())
    check(err_lse <= 2e-3, "dsm_pass1 vs plain", err_lse)

    rmax, rarg, cmax, carg = K.dsm_pass2(*ops, ref_r, ref_c)
    pr_max, pr_arg, pc_max, pc_arg = K.dsm_pass2_plain(*ops, ref_r, ref_c)
    agree_r = (rarg == pr_arg)[m0].float().mean().item()
    agree_c = (carg == pc_arg)[m1].float().mean().item()
    err_max = max((rmax - pr_max)[m0].abs().max().item(),
                  (cmax - pc_max)[m1].abs().max().item())
    check(min(agree_r, agree_c) >= 0.995, "argmax agreement", agree_r,
          agree_c)
    del pr_max, pr_arg, pc_max, pc_arg

    plain_stats = K.dual_softmax_stats_plain(f0, f1, m0, m1, 0.1)
    plain = K.matches_from_stats(plain_stats, m0, 0.2, 2048)
    del plain_stats
    ious = {}
    for fast in (False, True):
        fused = K.fused_extract_matches(f0, f1, m0, m1, 0.2, 2048, 0.1, fast)
        ious[fast] = min(iou(match_set(fused, b), match_set(plain, b))
                         for b in range(shape["b"]))
    check(ious[False] >= 0.95 and ious[True] >= 0.90, "match IoU", ious)
    check(min(len(match_set(plain, b)) for b in range(shape["b"])) > 100,
          "too few planted matches found")

    out.update(shape=shape, lse_max_abs_err=err_lse,
               argmax_max_abs_err=err_max, row_arg_agree=agree_r,
               col_arg_agree=agree_c, match_iou=ious[False],
               match_iou_fast_exp=ious[True])
    if timed:
        for name, fn, plain_fn, pass2, err in (
                ("dsm_pass1", lambda: K.dsm_pass1(*ops),
                 lambda: K.dsm_pass1_plain(*ops), False, err_lse),
                ("dsm_pass2", lambda: K.dsm_pass2(*ops, ref_r, ref_c),
                 lambda: K.dsm_pass2_plain(*ops, ref_r, ref_c), True,
                 err_max)):
            bound_ms, bound_by = bound(shape, pass2)
            ms = cuda_ms(fn, 10)
            out[name] = dict(ms=ms, plain_ms=cuda_ms(plain_fn, 3),
                             bound_ms=bound_ms, bound_by=bound_by,
                             share_of_bound=bound_ms / ms, max_abs_err=err)
    return out


def check_ties():
    """Identical f0 rows in row tiles 0, 2 and 14 tie for the maximum of
    one column, and identical f1 rows in column tiles 0, 1 and 10 for the
    maximum of one row: both passes' kernels, like the plain versions,
    give the first index."""
    from detectorfreesfm_tpu_torch.ops import fused_dsm as K

    rng = np.random.default_rng(7)
    n, c = 1000, 256
    f0 = rng.normal(0, 1, (1, n, c))
    f1 = rng.normal(0, 1, (1, n, c))
    v, w = (x * 40.0 / np.linalg.norm(x) for x in rng.normal(0, 1, (2, c)))
    tie_rows, col = [3, 130, 900], 11
    row, tie_cols = 500, [5, 70, 700]
    f0[0, tie_rows] = v
    f1[0, col] = v
    f0[0, row] = w
    f1[0, tie_cols] = w
    dev = torch.device("cuda")
    f0, f1 = (torch.tensor(x, dtype=torch.float32, device=dev)
              for x in (f0, f1))
    ones = torch.ones(1, n, dtype=torch.bool, device=dev)
    ops = K.split_features(f0, f1, ones, ones, 0.1)
    zeros = torch.zeros(1, n, device=dev)
    got = K.dsm_pass2(*ops, zeros, zeros)
    want = K.dsm_pass2_plain(*ops, zeros, zeros)
    check(got[3][0, col].item() == tie_rows[0]
          and want[3][0, col].item() == tie_rows[0], "column tie",
          got[3][0, col].item(), want[3][0, col].item())
    check(got[1][0, row].item() == tie_cols[0]
          and want[1][0, row].item() == tie_cols[0], "row tie",
          got[1][0, row].item(), want[1][0, row].item())
    check(bool((got[1] == want[1]).all()) and bool((got[3] == want[3]).all()),
          "tie case: kernel and plain argmaxes differ")
    return {"column_tie_arg": got[3][0, col].item(),
            "row_tie_arg": got[1][0, row].item()}


def profile_batch(engine, pairs, images):
    """Device time by kernel for one warm batch, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    engine.match_pairs(pairs, images)
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.match_pairs(pairs, images)
            torch.cuda.synchronize()
    except RuntimeError as e:  # no CUPTI tracing on this machine
        return {"not_measured": repr(e)}
    wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    # The two passes' sweeps and their combines, whatever their rank.
    dsm = [e for e in kernels if any(k in e.key for k in DSM_KERNELS)]
    # wall_ms includes the profiler's own start-up: no idle share from it.
    return dict(pairs=len(pairs), wall_ms=wall_ms, device_ms=dev_ms,
                dual_softmax_ms=sum(e.self_device_time_total
                                    for e in dsm) / 1e3,
                dual_softmax=[(e.key[:60], e.count,
                               e.self_device_time_total / 1e3) for e in dsm],
                top=[(e.key[:90], e.count, e.self_device_time_total / 1e3)
                     for e in top])


def main_path(params, dtype="float32"):
    """The 6 pairs through PairMatchingEngine with the kernels (batches of
    2), held to the dense path and to the JAX engine of the same compute
    dtype (JAX_MAIN)."""
    from detectorfreesfm_tpu_torch.data.images import from_array
    from detectorfreesfm_tpu_torch.data.synthetic import (
        SyntheticConfig,
        fundamental_matrix,
        generate_scene,
        symmetric_epipolar_error,
    )
    from detectorfreesfm_tpu_torch.match.engine import (
        EngineConfig,
        PairMatchingEngine,
    )
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs
    from detectorfreesfm_tpu_torch.ops import fused_dsm
    from detectorfreesfm_tpu_torch.ops.grid_merge import (
        merge_matches_to_keypoints,
    )

    t0 = time.time()
    imgs, _depths, K, q, t = generate_scene(
        0, SyntheticConfig(size=832, n_views=4))
    names = [f"view_{i}" for i in range(len(imgs))]
    images = {n: from_array(imgs[i]) for i, n in enumerate(names)}
    pairs = exhaustive_pairs(names)
    render_s = time.time() - t0

    def engine(fused):
        return PairMatchingEngine(EngineConfig(
            img_resize=832, fine_enabled=True, round_matches_ratio=4,
            fused_matching=fused, batch_size=2, compute_dtype=dtype), params)

    jax_valid, jax_median = JAX_MAIN[dtype]
    fused_engine = engine(True)
    fused_engine.match_pairs(pairs, images)  # warm-up (cuDNN, kernels)
    torch.cuda.synchronize()
    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0
    t0 = time.time()
    raw = fused_engine.match_pairs(pairs, images)
    keypoints, _scores, match_indices = merge_matches_to_keypoints(raw)
    torch.cuda.synchronize()
    fused_s = time.time() - t0
    launches = dict(fused_dsm.launches)
    # One dsm_pass1 and one dsm_pass2 per batch of 2 pairs.
    check(launches == {"dsm_pass1": 3, "dsm_pass2": 3},
          "kernel launches on the main path", launches)
    check(set(raw) == set(pairs) and set(keypoints) == set(names),
          "pairs or images missing from the output")

    profile = profile_batch(fused_engine, pairs[:2], images)

    dense_engine = engine(False)
    t0 = time.time()
    dense = dense_engine.match_pairs(pairs, images)
    torch.cuda.synchronize()
    dense_s = time.time() - t0
    ious = {f"{a}-{b}": iou(row_set(raw[(a, b)]), row_set(dense[(a, b)]))
            for a, b in pairs}
    check(min(ious.values()) >= 0.95, "fused vs dense IoU", ious)

    counts, errs = {}, []
    for (a, b), m in raw.items():
        i, j = names.index(a), names.index(b)
        F = fundamental_matrix(K[i], q[i], t[i], K[j], q[j], t[j])
        counts[f"{a}-{b}"] = len(m["conf"])
        errs.append(symmetric_epipolar_error(F, m["kpts0"], m["kpts1"]))
    median = float(np.median(np.concatenate(errs)))
    total = sum(counts.values())
    check(all(np.isfinite(m["kpts1"]).all() for m in raw.values()),
          "non-finite keypoints")
    check(total >= 0.9 * jax_valid, "valid matches", total, jax_valid)
    check(median <= jax_median + 0.5, "epipolar median", median, jax_median)
    return keypoints, match_indices, dict(
        render_s=render_s, fused_match_s=fused_s, dense_match_s=dense_s,
        pairs=len(pairs), fused_pairs_per_s=len(pairs) / fused_s,
        valid_per_pair=counts, total_valid=total,
        jax_total_valid=jax_valid, median_epipolar_px=median,
        jax_median_epipolar_px=jax_median,
        iou_fused_vs_dense=ious,
        n_keypoints={n: len(k) for n, k in keypoints.items()},
        n_index_matches=sum(len(v) for v in match_indices.values()),
        launches=launches, profile_one_batch=profile)


# ---------------------------------------------------------------------------
# The geometry phase: the slice beneath the mapper, fed by the main path's
# fused matches. The pair jobs come from the port mapper; the numpy glue
# below batches each estimator class once over all pairs or views, as the
# mapper's verify_pairs, _triangulate_tracks and _try_register call them
# one bucket or image at a time. The estimators come from a backend, so
# the JAX numbers below were recorded through the same glue with the JAX
# package's functions (`python tests/test_torch_sfm.py --record`, on the
# CPU).
# ---------------------------------------------------------------------------

VERIFY_THR_PX = 10.0      # MapperConfig.geometry_verify_thr
ABS_POSE_THR_PX = 12.0    # MapperConfig.abs_pose_max_error
FILTER_THR_PX = 10.0      # MapperConfig.filter_max_reproj_error
MIN_TRI_ANGLE_DEG = 1.5   # MapperConfig.min_tri_angle_deg
N_HYP = 512               # MapperConfig.ransac_hypotheses
N_HYP_H = max(64, N_HYP // 2)
N_HYP_PNP = max(256, N_HYP)
PLANAR_H_RATIO = 0.8      # MapperConfig.planar_h_ratio
MIN_PAIR_INLIERS = 8      # verify_pairs keeps pairs with >= 8 inliers
EH_IOU_MIN = 0.98         # E/H inlier sets this alike make the switch moot
DEMO_832 = os.path.join(REPO, "tests", "data", "torch", "demo_cached_832")
# Original (W, H) of the demo images (tests/test_demo_golden.py).
DEMO_SIZES = {
    "00318781_8039756060.jpg": (1057, 780),
    "01606161_5223112207.jpg": (1019, 679),
    "02786360_4030483701.jpg": (337, 447),
    "02928139_3448003521.jpg": (780, 1063),
    "03599123_13889501361.jpg": (773, 1038),
    "04398000_3306414527.jpg": (888, 1081),
    "04408102_2916920065.jpg": (773, 1039),
    "04477856_4856961901.jpg": (687, 1039),
}

# The JAX package's numbers on the same matches with the same keys.
JAX_GEOMETRY = {
    'two_view_a': {
        'view_0|view_1':
            {'n_e': 2048, 'n_h': 2048, 'switch': True, 'kept': True,
             'eh_iou': 1.0},
        'view_0|view_2':
            {'n_e': 2029, 'n_h': 2029, 'switch': True, 'kept': True,
             'eh_iou': 1.0},
        'view_0|view_3':
            {'n_e': 1976, 'n_h': 1976, 'switch': True, 'kept': True,
             'eh_iou': 1.0},
        'view_1|view_2':
            {'n_e': 2048, 'n_h': 2048, 'switch': True, 'kept': True,
             'eh_iou': 1.0},
        'view_1|view_3':
            {'n_e': 1973, 'n_h': 1972, 'switch': False, 'kept': True,
             'eh_iou': 0.9994931576279777},
        'view_2|view_3':
            {'n_e': 2031, 'n_h': 2031, 'switch': True, 'kept': True,
             'eh_iou': 1.0},
    },
    'two_view_b': {
        '00318781_8039756060.jpg|01606161_5223112207.jpg':
            {'n_e': 111, 'n_h': 40, 'switch': False, 'kept': True,
             'eh_iou': 0.14393939393939395},
        '00318781_8039756060.jpg|02786360_4030483701.jpg':
            {'n_e': 216, 'n_h': 49, 'switch': False, 'kept': True,
             'eh_iou': 0.0995850622406639},
        '00318781_8039756060.jpg|02928139_3448003521.jpg':
            {'n_e': 97, 'n_h': 24, 'switch': False, 'kept': True,
             'eh_iou': 0.07079646017699115},
        '00318781_8039756060.jpg|03599123_13889501361.jpg':
            {'n_e': 129, 'n_h': 47, 'switch': False, 'kept': True,
             'eh_iou': 0.0},
        '00318781_8039756060.jpg|04398000_3306414527.jpg':
            {'n_e': 201, 'n_h': 85, 'switch': False, 'kept': True,
             'eh_iou': 0.047619047619047616},
        '00318781_8039756060.jpg|04408102_2916920065.jpg':
            {'n_e': 195, 'n_h': 23, 'switch': False, 'kept': True,
             'eh_iou': 0.0845771144278607},
        '00318781_8039756060.jpg|04477856_4856961901.jpg':
            {'n_e': 177, 'n_h': 43, 'switch': False, 'kept': True,
             'eh_iou': 0.023255813953488372},
        '01606161_5223112207.jpg|02786360_4030483701.jpg':
            {'n_e': 85, 'n_h': 17, 'switch': False, 'kept': True,
             'eh_iou': 0.04081632653061224},
        '01606161_5223112207.jpg|02928139_3448003521.jpg':
            {'n_e': 68, 'n_h': 24, 'switch': False, 'kept': True,
             'eh_iou': 0.21052631578947367},
        '01606161_5223112207.jpg|03599123_13889501361.jpg':
            {'n_e': 450, 'n_h': 310, 'switch': False, 'kept': True,
             'eh_iou': 0.6703296703296703},
        '01606161_5223112207.jpg|04398000_3306414527.jpg':
            {'n_e': 67, 'n_h': 18, 'switch': False, 'kept': True,
             'eh_iou': 0.0},
        '01606161_5223112207.jpg|04408102_2916920065.jpg':
            {'n_e': 106, 'n_h': 18, 'switch': False, 'kept': True,
             'eh_iou': 0.13761467889908258},
        '01606161_5223112207.jpg|04477856_4856961901.jpg':
            {'n_e': 118, 'n_h': 18, 'switch': False, 'kept': True,
             'eh_iou': 0.0},
        '02786360_4030483701.jpg|02928139_3448003521.jpg':
            {'n_e': 162, 'n_h': 28, 'switch': False, 'kept': True,
             'eh_iou': 0.13095238095238096},
        '02786360_4030483701.jpg|03599123_13889501361.jpg':
            {'n_e': 103, 'n_h': 43, 'switch': False, 'kept': True,
             'eh_iou': 0.10606060606060606},
        '02786360_4030483701.jpg|04398000_3306414527.jpg':
            {'n_e': 137, 'n_h': 51, 'switch': False, 'kept': True,
             'eh_iou': 0.18238993710691823},
        '02786360_4030483701.jpg|04408102_2916920065.jpg':
            {'n_e': 235, 'n_h': 34, 'switch': False, 'kept': True,
             'eh_iou': 0.1115702479338843},
        '02786360_4030483701.jpg|04477856_4856961901.jpg':
            {'n_e': 178, 'n_h': 64, 'switch': False, 'kept': True,
             'eh_iou': 0.04310344827586207},
        '02928139_3448003521.jpg|03599123_13889501361.jpg':
            {'n_e': 127, 'n_h': 25, 'switch': False, 'kept': True,
             'eh_iou': 0.10144927536231885},
        '02928139_3448003521.jpg|04398000_3306414527.jpg':
            {'n_e': 319, 'n_h': 115, 'switch': False, 'kept': True,
             'eh_iou': 0.3312883435582822},
        '02928139_3448003521.jpg|04408102_2916920065.jpg':
            {'n_e': 173, 'n_h': 40, 'switch': False, 'kept': True,
             'eh_iou': 0.16393442622950818},
        '02928139_3448003521.jpg|04477856_4856961901.jpg':
            {'n_e': 245, 'n_h': 93, 'switch': False, 'kept': True,
             'eh_iou': 0.3684210526315789},
        '03599123_13889501361.jpg|04398000_3306414527.jpg':
            {'n_e': 360, 'n_h': 130, 'switch': False, 'kept': True,
             'eh_iou': 0.32075471698113206},
        '03599123_13889501361.jpg|04408102_2916920065.jpg':
            {'n_e': 202, 'n_h': 32, 'switch': False, 'kept': True,
             'eh_iou': 0.14146341463414633},
        '03599123_13889501361.jpg|04477856_4856961901.jpg':
            {'n_e': 142, 'n_h': 24, 'switch': False, 'kept': True,
             'eh_iou': 0.11409395973154363},
        '04398000_3306414527.jpg|04408102_2916920065.jpg':
            {'n_e': 333, 'n_h': 138, 'switch': False, 'kept': True,
             'eh_iou': 0.11084905660377359},
        '04398000_3306414527.jpg|04477856_4856961901.jpg':
            {'n_e': 195, 'n_h': 28, 'switch': False, 'kept': True,
             'eh_iou': 0.08780487804878048},
        '04408102_2916920065.jpg|04477856_4856961901.jpg':
            {'n_e': 242, 'n_h': 51, 'switch': False, 'kept': True,
             'eh_iou': 0.08118081180811808},
    },
    'pose_err_a': {
        'view_0|view_1': (0.054368820751851496, 0.03118174151646111),
        'view_0|view_2': (0.053695586172464026, 0.041386650582596864),
        'view_0|view_3': (0.03532666705447991, 0.03389327801439496),
        'view_1|view_2': (0.03128986750207549, 0.034181371158185106),
        'view_1|view_3': (0.02309052856193762, 0.03268589611721492),
        'view_2|view_3': (0.030595099543770144, 0.02069917603354768),
    },
    'e_pose_err_a': {
        'view_0|view_1': (22.007957471821168, 94.08367331283561),
        'view_0|view_2': (25.376415273134647, 51.88817934729132),
        'view_0|view_3': (17.869383989715832, 54.04068889349809),
        'view_1|view_2': (42.711043469982684, 47.23552404224288),
        'view_1|view_3': (28.40324122963895, 51.494268696546996),
        'view_2|view_3': (34.81003740741563, 76.87431683085053),
    },
    'n_tracks': 8668,
    'n_points': 8667,
    'median_reproj_px': 0.6525183133032073,
    'pnp': {
        'view_0': 0.029713453483138873,
        'view_1': 0.06249249009364793,
        'view_2': 0.277352408862378,
        'view_3': 0.0534042730102047,
    },
    'ba4_cost_per_obs': 0.6738953214926913,
    # (n_e, n_h) on the pair and on 8 one-ulp perturbations of x0
    'count_trials': {
        'view_0|view_1':
            [(2048, 2048)],
        'view_0|view_2':
            [(2029, 2029)],
        'view_0|view_3':
            [(1976, 1976)],
        'view_1|view_2':
            [(2048, 2048)],
        'view_1|view_3':
            [(1973, 1972)],
        'view_2|view_3':
            [(2031, 2031)],
        '00318781_8039756060.jpg|01606161_5223112207.jpg':
            [(111, 40)],
        '00318781_8039756060.jpg|02786360_4030483701.jpg':
            [(216, 49)],
        '00318781_8039756060.jpg|02928139_3448003521.jpg':
            [(97, 24)],
        '00318781_8039756060.jpg|03599123_13889501361.jpg':
            [(129, 47)],
        '00318781_8039756060.jpg|04398000_3306414527.jpg':
            [(201, 85)],
        '00318781_8039756060.jpg|04408102_2916920065.jpg':
            [(195, 23)],
        '00318781_8039756060.jpg|04477856_4856961901.jpg':
            [(177, 43)],
        '01606161_5223112207.jpg|02786360_4030483701.jpg':
            [(85, 17)],
        '01606161_5223112207.jpg|02928139_3448003521.jpg':
            [(68, 24)],
        '01606161_5223112207.jpg|03599123_13889501361.jpg':
            [(450, 310)],
        '01606161_5223112207.jpg|04398000_3306414527.jpg':
            [(67, 18)],
        '01606161_5223112207.jpg|04408102_2916920065.jpg':
            [(106, 18)],
        '01606161_5223112207.jpg|04477856_4856961901.jpg':
            [(118, 18)],
        '02786360_4030483701.jpg|02928139_3448003521.jpg':
            [(162, 28)],
        '02786360_4030483701.jpg|03599123_13889501361.jpg':
            [(103, 43)],
        '02786360_4030483701.jpg|04398000_3306414527.jpg':
            [(137, 51)],
        '02786360_4030483701.jpg|04408102_2916920065.jpg':
            [(235, 34)],
        '02786360_4030483701.jpg|04477856_4856961901.jpg':
            [(178, 64)],
        '02928139_3448003521.jpg|03599123_13889501361.jpg':
            [(127, 25)],
        '02928139_3448003521.jpg|04398000_3306414527.jpg':
            [(319, 115)],
        '02928139_3448003521.jpg|04408102_2916920065.jpg':
            [(173, 40)],
        '02928139_3448003521.jpg|04477856_4856961901.jpg':
            [(245, 93)],
        '03599123_13889501361.jpg|04398000_3306414527.jpg':
            [(360, 130)],
        '03599123_13889501361.jpg|04408102_2916920065.jpg':
            [(202, 32)],
        '03599123_13889501361.jpg|04477856_4856961901.jpg':
            [(142, 24)],
        '04398000_3306414527.jpg|04408102_2916920065.jpg':
            [(327, 138), (333, 138)],
        '04398000_3306414527.jpg|04477856_4856961901.jpg':
            [(195, 28)],
        '04408102_2916920065.jpg|04477856_4856961901.jpg':
            [(242, 51)],
    },
}


def _pow2(n, lo=64):
    m = lo
    while m < n:
        m *= 2
    return m


def _rotmat(q):
    from detectorfreesfm_tpu_torch.core.geometry import np_quat_to_rotmat

    return np_quat_to_rotmat(np.asarray(q, np.float64))


def _angle_deg(R):
    return float(np.degrees(np.arccos(np.clip(
        (np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def _so3_exp_np(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def pair_jobs(keypoints, match_indices, sizes, intrinsics=None):
    """The port mapper's verification jobs at focal factor 1, as
    (na, nb, m, x0, x1, f_mean) with normalized float32 coordinates,
    sorted by pair; without intrinsics, the focal the mapper guesses from
    the image size. (Building them runs numpy only.)"""
    from detectorfreesfm_tpu_torch.sfm.mapper import IncrementalMapper

    mapper = IncrementalMapper(device="cpu")
    rec = mapper._setup(keypoints, sizes, intrinsics)
    return [(na, nb, m.astype(np.int64), x0, x1, f)
            for na, nb, _ia, _ib, m, x0, x1, f in mapper.pair_jobs(
                rec, match_indices)]


def verify_batch(jobs):
    """One padded batch over all pairs (shared N), with verify_pairs'
    thresholds and content-hash keys."""
    from detectorfreesfm_tpu_torch.utils.prng import stable_rngs

    n_pad = _pow2(max(len(j[2]) for j in jobs))
    B = len(jobs)
    x0 = np.zeros((B, n_pad, 2), np.float32)
    x1 = np.zeros((B, n_pad, 2), np.float32)
    mask = np.zeros((B, n_pad), bool)
    thr = np.zeros(B, np.float32)
    for r, (_na, _nb, m, a, b, f) in enumerate(jobs):
        x0[r, :len(m)], x1[r, :len(m)], mask[r, :len(m)] = a, b, True
        thr[r] = VERIFY_THR_PX / f
    keys_e = stable_rngs([("verify", j[0], j[1], 0) for j in jobs])
    keys_h = stable_rngs([("homog", j[0], j[1]) for j in jobs])
    return x0, x1, mask, thr, keys_e, keys_h


def two_view(backend, jobs, timer):
    """Essential and homography RANSAC over all pairs; per pair the counts,
    the kept inlier matches (the H-inliers where verify_pairs switches to
    H), the E pose, and the pose the mapper seeds with (_twoview_pose:
    decompose_homography where h_ratio > planar_h_ratio, else E's)."""
    x0, x1, mask, thr, keys_e, keys_h = verify_batch(jobs)
    e = timer(backend.relpose, x0, x1, mask, keys_e, thr, N_HYP)
    h = timer(backend.homography, x0, x1, mask, keys_h, thr, N_HYP_H)
    out = {}
    for r, (na, nb, m, *_rest) in enumerate(jobs):
        n_e, n_h = int(e["n"][r]), int(h["n"][r])
        kept = n_e >= MIN_PAIR_INLIERS
        h_ratio = n_h / max(n_e, 1)
        switch = bool(kept and h_ratio > PLANAR_H_RATIO and n_h >= n_e)
        inl_e, inl_h = e["inliers"][r, :len(m)], h["inliers"][r, :len(m)]
        inl = inl_h if switch else inl_e
        q_seed, t_seed = e["q"][r], e["t"][r]
        if h_ratio > PLANAR_H_RATIO:
            q_seed, t_seed = timer(backend.decompose, h["H"][r], x0[r],
                                   x1[r], h["inliers"][r], mask[r])
        out[f"{na}|{nb}"] = dict(
            n_e=n_e, n_h=n_h, kept=kept, switch=switch,
            eh_iou=float((inl_e & inl_h).sum() / max((inl_e | inl_h).sum(),
                                                     1)),
            matches=m[inl], q=e["q"][r], t=e["t"][r], q_seed=q_seed,
            t_seed=t_seed)
    return out, (x0, x1, mask, thr, keys_e, keys_h)


def count_trials(backend, jobs, n=8, seed=0):
    """Each pair's (n_e, n_h) on its own input and on `n` copies of it with
    x0 perturbed by about one float32 ulp (relative N(0, 6e-8)), with the
    same draws. A pair whose RANSAC has two attractors a rounding apart
    shows both: the other backend's rounding may land on either."""
    x0, x1, mask, thr, keys_e, keys_h = verify_batch(jobs)
    rng = np.random.default_rng(seed)
    trials = [x0] + [x0 * (1 + rng.normal(0, 6e-8, x0.shape)).astype(
        np.float32) for _ in range(n)]
    out = {f"{j[0]}|{j[1]}": set() for j in jobs}
    for xp in trials:
        e = backend.relpose(xp, x1, mask, keys_e, thr, N_HYP)
        h = backend.homography(xp, x1, mask, keys_h, thr, N_HYP_H)
        for r, j in enumerate(jobs):
            out[f"{j[0]}|{j[1]}"].add((int(e["n"][r]), int(h["n"][r])))
    return {k: sorted(v) for k, v in out.items()}


def relative_pose_errors(res, names, q, t, which=""):
    """Rotation and (signed) translation-direction errors in degrees of each
    pair's pose (E's, or with which="_seed" the mapper's seed pose)
    against the scene's true relative pose."""
    errs = {}
    R = _rotmat(q)
    for key, r in res.items():
        a, b = key.split("|")
        i, j = names.index(a), names.index(b)
        R_rel = R[j] @ R[i].T
        t_rel = t[j] - R_rel @ t[i]
        t_est = np.asarray(r["t" + which], np.float64)
        cos = float(np.dot(t_est, t_rel)
                    / max(np.linalg.norm(t_est) * np.linalg.norm(t_rel),
                          1e-12))
        errs[key] = (_angle_deg(_rotmat(r["q" + which]) @ R_rel.T),
                     float(np.degrees(np.arccos(np.clip(cos, -1, 1)))))
    return errs


def scene_tracks(backend, names, keypoints, res, timer):
    """Tracks over the kept inlier matches, by image id (1-based in sorted
    name order, as the mapper numbers images)."""
    ids = {n: i + 1 for i, n in enumerate(sorted(names))}
    n_kpts = {ids[n]: len(keypoints[n]) for n in names}
    matches = {}
    for key, r in res.items():
        if r["kept"]:
            a, b = key.split("|")
            matches[(ids[a], ids[b])] = r["matches"]
    tracks = timer(backend.tracks, n_kpts, matches)
    return ids, tracks


def triangulate(backend, tracks, ids, keypoints, K, q, t, names, timer,
                exclude=None):
    """Every track of >= 2 usable views by DLT at the true poses, padded to
    4 views, then _triangulate_tracks' acceptance: front, reprojection
    error <= FILTER_THR_PX, >= 2 good views spanning >= MIN_TRI_ANGLE_DEG.
    `exclude` (an image id) drops that view's observations first."""
    by_id = {ids[n]: n for n in names}
    R = _rotmat(q)
    cand = []
    for ti, tr in enumerate(tracks):
        obs = [(i, k) for i, k in tr.observations if i != exclude]
        if len(obs) >= 2:
            cand.append((ti, obs))
    n, V = len(cand), 4
    n_pad = _pow2(n, lo=32)
    P = np.zeros((n_pad, V, 3, 4), np.float32)
    UV = np.zeros((n_pad, V, 2), np.float32)
    M = np.zeros((n_pad, V), bool)
    Rv = np.zeros((n, V, 3, 3))
    tv = np.zeros((n, V, 3))
    Cv = np.zeros((n, V, 3))
    Kv = np.zeros((n, V, 3, 3))
    for r, (_ti, obs) in enumerate(cand):
        for v, (img, kpt) in enumerate(obs):
            name = by_id[img]
            c = names.index(name)
            P[r, v, :, :3] = K[c] @ R[c]
            P[r, v, :, 3] = K[c] @ t[c]
            UV[r, v] = keypoints[name][kpt]
            M[r, v] = True
            Rv[r, v], tv[r, v], Kv[r, v] = R[c], t[c], K[c]
            Cv[r, v] = -R[c].T @ t[c]
    X, ok = timer(backend.triangulate, P, UV, M)
    X = np.asarray(X, np.float64)[:n]
    ok = np.asarray(ok)[:n] & np.all(np.isfinite(X), axis=1)
    live = M[:n]
    Xc = np.einsum("nvij,nj->nvi", Rv, X) + tv
    z = Xc[..., 2]
    zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
    uvp = np.einsum("nvij,nvj->nvi", Kv, Xc / zs[..., None])[..., :2]
    err = np.linalg.norm(uvp - UV[:n], axis=-1)
    good = live & (z > 1e-6) & (err <= FILTER_THR_PX) & ok[:, None]
    rays = Cv - X[:, None, :]
    rays /= np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
    ang = np.degrees(np.arccos(np.clip(
        np.einsum("nvi,nwi->nvw", rays, rays), -1.0, 1.0)))
    ang = np.where(good[:, :, None] & good[:, None, :], ang, 0.0)
    keep = (good.sum(1) >= 2) & (ang.max(axis=(1, 2)) >= MIN_TRI_ANGLE_DEG)
    pts = [dict(track=cand[r][0], xyz=X[r],
                obs=[cand[r][1][v] for v in range(V) if good[r, v]],
                err=err[r][good[r]]) for r in np.flatnonzero(keep)]
    return pts


def register(backend, tracks, ids, keypoints, K, q, t, names, timer):
    """Each view against the points triangulated from the other three
    (one batched PnP call), then refine_pose on its inliers. Returns the
    per-view poses before and after refinement and the inlier counts."""
    rows = []
    for n in names:
        img = ids[n]
        pts = triangulate(backend, tracks, ids, keypoints, K, q, t, names,
                          timer, exclude=img)
        X, uv = [], []
        for p in pts:
            kpt = dict(tracks[p["track"]].observations).get(img)
            if kpt is not None:
                X.append(p["xyz"])
                uv.append(keypoints[n][kpt])
        rows.append((n, np.asarray(X), np.asarray(uv, np.float64)))
    from detectorfreesfm_tpu_torch.utils.prng import stable_rngs

    n_pad = _pow2(max(len(r[1]) for r in rows))
    B = len(rows)
    Xb = np.zeros((B, n_pad, 3), np.float32)
    xb = np.zeros((B, n_pad, 2), np.float32)
    mb = np.zeros((B, n_pad), bool)
    thr = np.zeros(B, np.float32)
    for r, (n, X, uv) in enumerate(rows):
        c = names.index(n)
        Kc = K[c]
        Xb[r, :len(X)] = X
        xb[r, :len(X)] = np.stack([(uv[:, 0] - Kc[0, 2]) / Kc[0, 0],
                                   (uv[:, 1] - Kc[1, 2]) / Kc[1, 1]], -1)
        mb[r, :len(X)] = True
        thr[r] = ABS_POSE_THR_PX / ((Kc[0, 0] + Kc[1, 1]) / 2)
    keys = stable_rngs([("register", n, len(X), 0) for n, X, _ in rows])
    res = timer(backend.pnp, Xb, xb, mb, keys, thr, N_HYP_PNP)
    out = {}
    R = _rotmat(q)
    for r, (n, X, _uv) in enumerate(rows):
        c = names.index(n)
        q_ref, t_ref = timer(backend.refine, res["q"][r], res["t"][r],
                             Xb[r], xb[r], res["inliers"][r])
        out[n] = dict(
            n_points=len(X), n_inliers=int(res["n"][r]),
            rot_err_deg=_angle_deg(_rotmat(res["q"][r]) @ R[c].T),
            refined_rot_err_deg=_angle_deg(_rotmat(q_ref) @ R[c].T),
            refined_t_err=float(np.linalg.norm(np.asarray(t_ref) - t[c])))
    return out


def ba_four_view(pts, ids, K, q, t, names, keypoints, seed=7):
    """BA problem (i): the triangulated 4-view model, cameras 1..3 and the
    points perturbed from a seed; cameras 0 and 1 fixed (similarity
    gauge: camera 0's pose and one translation component of camera 1)."""
    from detectorfreesfm_tpu_torch.core.geometry import np_rotmat_to_quat

    rng = np.random.default_rng(seed)
    R = _rotmat(q)
    qv, tv = [], []
    for c in range(len(names)):
        Rc, tc = R[c], np.array(t[c], np.float64)
        if c > 0:
            Rc = _so3_exp_np(rng.normal(0, 0.01, 3)) @ Rc
            tc = tc + rng.normal(0, 0.02, 3) * np.linalg.norm(tc)
        qv.append(np_rotmat_to_quat(Rc))
        tv.append(tc)
    X = np.stack([p["xyz"] for p in pts])
    scale = float(np.median(np.linalg.norm(X - X.mean(0), axis=1)))
    X = X + rng.normal(0, 0.01 * scale, X.shape)
    by_id = {ids[n]: n for n in names}
    uv, cam, pt = [], [], []
    for j, p in enumerate(pts):
        for img, kpt in p["obs"]:
            name = by_id[img]
            uv.append(keypoints[name][kpt])
            cam.append(names.index(name))
            pt.append(j)
    intr = np.stack([[Kc[0, 0], Kc[1, 1], Kc[0, 2], Kc[1, 2]] for Kc in K])
    fixed = np.zeros(len(names), bool)
    fixed[:2] = True
    return ((np.stack(qv), np.stack(tv), intr, X, np.asarray(uv, np.float64),
             np.asarray(cam), np.asarray(pt)),
            dict(fixed_cams=fixed, gauge="similarity", max_iters=30))


def _look_at(eye, target):
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def ba_synthetic(n_cams, n_pts, seed):
    """A synthetic BA problem made as tests/test_sfm.py makes its 500-camera
    one: cameras on an arc around a box of points, exact observations, a
    perturbed start; n_pts points, each seen in 4-10 random views of the
    cameras that see it. Returns (args, kwargs, K)."""
    from detectorfreesfm_tpu_torch.core.geometry import np_rotmat_to_quat

    rng = np.random.default_rng(seed)
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
    # candidates enough that n_pts of them are seen by >= 4 cameras
    pts = rng.uniform(-4, 4, (int(n_pts * 1.4), 3)) + np.array([0, 0, 10.0])
    Rs, ts = [], []
    for i in range(n_cams):
        ang = (i / n_cams - 0.5) * 1.2
        eye = np.array([8 * np.sin(ang), 0.3 * np.sin(i),
                        10 - 8 * np.cos(ang)])
        R = _look_at(eye, np.array([0, 0, 10.0]))
        Rs.append(R)
        ts.append(-R @ eye)
    Rs, ts = np.stack(Rs), np.stack(ts)
    Xc = np.einsum("cij,pj->pci", Rs, pts) + ts[None]       # (P, C, 3)
    z = Xc[..., 2]
    uv = Xc[..., :2] / np.where(z > 1e-6, z, 1.0)[..., None] * 600.0 \
        + np.array([320.0, 240.0])
    vis = (z > 0.5) & (uv[..., 0] > 0) & (uv[..., 0] < 640) \
        & (uv[..., 1] > 0) & (uv[..., 1] < 480)
    k = rng.integers(4, 11, len(pts))
    score = np.where(vis, rng.random(vis.shape), -1.0)
    rank = np.argsort(np.argsort(-score, axis=1), axis=1)
    sel = vis & (rank < k[:, None])
    keep = np.flatnonzero(sel.sum(1) >= 4)[:n_pts]
    check(len(keep) == n_pts, "BA problem: too few visible points")
    pts, sel, uv = pts[keep], sel[keep], uv[keep]
    obs_pt, obs_cam = np.nonzero(sel)
    obs_uv = uv[obs_pt, obs_cam]
    order = np.argsort(obs_cam, kind="stable")
    obs_pt, obs_cam, obs_uv = obs_pt[order], obs_cam[order], obs_uv[order]
    qvec = np_rotmat_to_quat(Rs)
    tvec = ts.copy()
    tvec[2:] += rng.normal(0, 0.03, (n_cams - 2, 3))
    pts_noisy = pts + rng.normal(0, 0.02, pts.shape)
    intr = np.tile(np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
                   (n_cams, 1))
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    return ((qvec, tvec, intr, pts_noisy, obs_uv, obs_cam, obs_pt),
            dict(fixed_cams=fixed), K)


def mean_reproj_every_25th(q, t, pts, obs_uv, obs_cam, obs_pt, K):
    """tests/test_sfm.py's check: the mean pixel error of every 25th
    camera's observations under the adjusted poses and points."""
    R = _rotmat(q)
    errs = []
    for i in range(0, len(q), 25):
        sel = obs_cam == i
        Xc = pts[obs_pt[sel]] @ R[i].T + t[i]
        uv = (Xc / Xc[:, 2:]) @ K.T
        errs.append(np.linalg.norm(uv[:, :2] - obs_uv[sel], axis=1))
    return float(np.mean(np.concatenate(errs)))


class PortGeometry:
    """The port's estimators on one device, numpy in and out."""

    def __init__(self, device):
        self.device = device

    def _g(self, keys, n_hyp, n):
        from detectorfreesfm_tpu_torch.utils.prng import gumbel

        return gumbel(keys, (n_hyp, n), device=self.device)

    @staticmethod
    def _np(x):
        return x.cpu().numpy()

    def relpose(self, x0, x1, mask, keys, thr, n_hyp):
        from detectorfreesfm_tpu_torch.sfm.twoview import (
            estimate_relative_pose_batch,
        )

        r = estimate_relative_pose_batch(
            x0, x1, mask, self._g(keys, n_hyp, x0.shape[1]), thr,
            device=self.device)
        return dict(n=self._np(r.n_inliers), inliers=self._np(r.inliers),
                    q=self._np(r.qvec).astype(np.float64),
                    t=self._np(r.tvec).astype(np.float64))

    def homography(self, x0, x1, mask, keys, thr, n_hyp):
        from detectorfreesfm_tpu_torch.sfm.twoview import (
            estimate_homography_batch,
        )

        r = estimate_homography_batch(
            x0, x1, mask, self._g(keys, n_hyp, x0.shape[1]), thr,
            device=self.device)
        return dict(n=self._np(r.n_inliers), inliers=self._np(r.inliers),
                    H=self._np(r.H))

    def decompose(self, H, x0, x1, inliers, mask):
        from detectorfreesfm_tpu_torch.core.geometry import rotmat_to_quat
        from detectorfreesfm_tpu_torch.sfm.twoview import (
            decompose_homography,
        )

        R, t, _n = decompose_homography(H, x0, x1, inliers, mask,
                                        device=self.device)
        return (self._np(rotmat_to_quat(R)).astype(np.float64),
                self._np(t).astype(np.float64))

    def triangulate(self, P, uv, mask):
        from detectorfreesfm_tpu_torch.core.triangulation import (
            triangulate_dlt,
        )

        X, ok = triangulate_dlt(P, uv, mask, device=self.device)
        return self._np(X), self._np(ok)

    def pnp(self, X, x, mask, keys, thr, n_hyp):
        from detectorfreesfm_tpu_torch.sfm.pnp import (
            estimate_absolute_pose_batch,
        )

        r = estimate_absolute_pose_batch(
            X, x, mask, self._g(keys, n_hyp, X.shape[1]), thr,
            device=self.device)
        return dict(n=self._np(r.n_inliers), inliers=self._np(r.inliers),
                    q=self._np(r.qvec).astype(np.float64),
                    t=self._np(r.tvec).astype(np.float64))

    def refine(self, q, t, X, x, mask):
        from detectorfreesfm_tpu_torch.sfm.pnp import refine_pose

        q2, t2 = refine_pose(q, t, X, x, mask, device=self.device)
        return self._np(q2).astype(np.float64), self._np(t2).astype(
            np.float64)

    def ba(self, args, kw):
        from detectorfreesfm_tpu_torch.sfm.ba import bundle_adjust

        info = {}
        out = bundle_adjust(*args, device=self.device, info=info, **kw)
        return out, info

    def tracks(self, n_kpts, matches, builder="native"):
        from detectorfreesfm_tpu_torch.sfm.tracks import build_tracks

        return build_tracks(n_kpts, matches, builder=builder)


class Timer:
    """Calls a function, syncs the card, and adds its wall time to
    `seconds`; the rest of a step's wall time is its host share."""

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, fn, *args):
        t0 = time.time()
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.seconds += time.time() - t0
        return out


def synthetic_inputs(keypoints, match_indices):
    """The main path's scene: names, true K, q, t, and the pair jobs."""
    from detectorfreesfm_tpu_torch.data.synthetic import (
        SyntheticConfig,
        generate_scene,
    )

    _imgs, _d, K, q, t = generate_scene(0, SyntheticConfig(size=832,
                                                           n_views=4))
    names = [f"view_{i}" for i in range(4)]
    jobs = pair_jobs(keypoints, match_indices, {n: (832, 832) for n in names},
                     {n: K[i] for i, n in enumerate(names)})
    return names, K, q, t, jobs


def demo_inputs(kps, matches):
    """demo_cached_832's pairs with the intrinsics IncrementalMapper._setup
    guesses from the image sizes."""
    return pair_jobs(kps, matches, {n: DEMO_SIZES[n] for n in kps})


def geometry_reference(backend, keypoints, match_indices, demo_kps,
                       demo_matches):
    """The gated numbers of steps 2-5(i) through one backend; what the JAX
    recorder and the card both compute."""
    timer = Timer()
    names, K, q, t, jobs = synthetic_inputs(keypoints, match_indices)
    jobs_b = demo_inputs(demo_kps, demo_matches)
    res_a, _ = two_view(backend, jobs, timer)
    res_b, _ = two_view(backend, jobs_b, timer)
    ids, tracks = scene_tracks(backend, names, keypoints, res_a, timer)
    pts = triangulate(backend, tracks, ids, keypoints, K, q, t, names, timer)
    reg = register(backend, tracks, ids, keypoints, K, q, t, names, timer)
    args, kw = ba_four_view(pts, ids, K, q, t, names, keypoints)
    (_q, _t, _i, _p, cost), info = backend.ba(args, kw)
    return dict(
        gated_numbers(res_a, res_b, names, q, t, tracks, pts, reg, cost),
        ba4_iterations=info.get("iterations"),
        count_trials={**count_trials(backend, jobs),
                      **count_trials(backend, jobs_b)})


def gated_numbers(res_a, res_b, names, q, t, tracks, pts, reg, ba4_cost):
    """What _check_gates compares, from each step's results."""
    def counts(res):
        return {k: dict(n_e=v["n_e"], n_h=v["n_h"], switch=v["switch"],
                        kept=v["kept"], eh_iou=v["eh_iou"])
                for k, v in res.items()}

    return dict(
        two_view_a=counts(res_a),
        pose_err_a=relative_pose_errors(res_a, names, q, t, "_seed"),
        e_pose_err_a=relative_pose_errors(res_a, names, q, t),
        two_view_b=counts(res_b),
        n_tracks=len(tracks), n_points=len(pts),
        median_reproj_px=float(np.median(np.concatenate(
            [p["err"] for p in pts]))),
        pnp={n: r["refined_rot_err_deg"] for n, r in reg.items()},
        ba4_cost_per_obs=float(ba4_cost))


def _check_gates(got, ref):
    """Hold the card's geometry numbers to the JAX package's."""
    for part in ("two_view_a", "two_view_b"):
        check(got[part].keys() == ref[part].keys(), part, "pairs differ")
        for k, g in got[part].items():
            # The card's counts within 1% (rounded up to a whole inlier) of
            # the counts JAX gives on this pair or on its one-ulp
            # perturbations (count_trials), and the kept and switch
            # decisions of that JAX outcome. Where its counts lie within
            # those tolerances of the rule's boundary (n_e = 8; n_h = n_e;
            # n_h = 0.8 n_e), counts that pass can fall on either side: a
            # kept decision is then free, and a switch decision only where
            # it does not change what is kept (the card's E and H inlier
            # sets agree to IoU >= EH_IOU_MIN). The synthetic scene is
            # planar, so JAX has n_h = n_e (or one apart) on all of (a).
            ok = []
            for n_e, n_h in ref["count_trials"][k]:
                le, lh = int(np.ceil(0.01 * n_e)), int(np.ceil(0.01 * n_h))
                if abs(g["n_e"] - n_e) > le or abs(g["n_h"] - n_h) > lh:
                    continue
                kept = n_e >= MIN_PAIR_INLIERS
                switch = kept and n_h / max(n_e, 1) > PLANAR_H_RATIO \
                    and n_h >= n_e
                edge_kept = abs(n_e - MIN_PAIR_INLIERS) <= le
                edge_switch = (abs(n_h - n_e) <= lh + le or abs(
                    n_h - PLANAR_H_RATIO * n_e) <= lh + PLANAR_H_RATIO * le)
                ok.append((g["kept"] == kept or edge_kept)
                          and (g["switch"] == switch or (
                              edge_switch and g["eh_iou"] >= EH_IOU_MIN)))
            check(any(ok), part, k, "counts or decisions", g,
                  ref["count_trials"][k])
    for k, (rot, tr) in got["pose_err_a"].items():
        r_rot, r_tr = ref["pose_err_a"][k]
        check(rot <= r_rot + 0.05 and tr <= r_tr + 0.5, "pose error", k,
              (rot, tr), (r_rot, r_tr))
    check(abs(got["n_points"] - ref["n_points"]) <= 0.01 * ref["n_points"],
          "triangulated points", got["n_points"], ref["n_points"])
    check(got["median_reproj_px"] <= ref["median_reproj_px"] + 0.05,
          "median reprojection", got["median_reproj_px"],
          ref["median_reproj_px"])
    for n, e in got["pnp"].items():
        check(e <= ref["pnp"][n] + 0.05, "PnP rotation", n, e, ref["pnp"][n])
    check(got["ba4_cost_per_obs"] <= 1.05 * ref["ba4_cost_per_obs"],
          "BA (i) cost", got["ba4_cost_per_obs"], ref["ba4_cost_per_obs"])


def _model_store(pts, ids, names, K, keypoints, match_indices, ba_out,
                 workdir):
    """Step 6: the BA'd 4-view model through Reconstruction, colmap_io
    (bin, txt, PLY), the COLMAP database and model_select."""
    from detectorfreesfm_tpu_torch.data import colmap_io
    from detectorfreesfm_tpu_torch.data.database import (
        COLMAPDatabase,
        export_scene_to_database,
        image_ids_to_pair_id,
    )
    from detectorfreesfm_tpu_torch.sfm import model_select
    from detectorfreesfm_tpu_torch.sfm.reconstruction import (
        Reconstruction,
        RImage,
    )

    q_ba, t_ba, _intr, X_ba, _cost = ba_out
    rec = Reconstruction()
    for c, n in enumerate(names):
        i = ids[n]
        Kc = K[c]
        rec.add_camera(colmap_io.Camera(
            i, "PINHOLE", 832, 832,
            np.array([Kc[0, 0], Kc[1, 1], Kc[0, 2], Kc[1, 2]])))
        rec.add_image(RImage(id=i, name=n, camera_id=i,
                             xys=np.asarray(keypoints[n], np.float64)))
        rec.set_pose(i, q_ba[c], t_ba[c])
    for j, p in enumerate(pts):
        rec.add_point(X_ba[j], p["obs"])
    errs = rec.reprojection_errors()
    for pid, e in errs.items():
        rec.points[pid]["error"] = float(np.mean(e))
    mean_err = float(np.mean(np.concatenate(list(errs.values()))))

    def same(a, b):
        ca, ia, pa = a
        cb, ib, pb = b
        check(ca.keys() == cb.keys() and ia.keys() == ib.keys()
              and pa.keys() == pb.keys(), "model keys differ")
        for k in ca:
            check(ca[k].model == cb[k].model
                  and np.array_equal(ca[k].params, cb[k].params), "camera", k)
        for k in ia:
            x, y = ia[k], ib[k]
            check(x.name == y.name and np.array_equal(x.qvec, y.qvec)
                  and np.array_equal(x.tvec, y.tvec)
                  and np.array_equal(x.xys, y.xys)
                  and np.array_equal(x.point3D_ids, y.point3D_ids),
                  "image", k)
        for k in pa:
            x, y = pa[k], pb[k]
            check(np.array_equal(x.xyz, y.xyz) and np.array_equal(x.rgb, y.rgb)
                  and x.error == y.error
                  and np.array_equal(x.image_ids, y.image_ids)
                  and np.array_equal(x.point2D_idxs, y.point2D_idxs),
                  "point", k)

    model = rec.to_colmap()
    for ext in (".bin", ".txt"):
        d = os.path.join(workdir, "model" + ext.replace(".", "_"))
        rec.write(d, ext)
        same(model, colmap_io.read_model(d, ext))
        back = Reconstruction.from_colmap(*colmap_io.read_model(d, ext))
        same(model, back.to_colmap())
    ply = os.path.join(workdir, "points.ply")
    colmap_io.write_ply(model[2], ply)
    with open(ply, "rb") as f:
        blob = f.read()
    body = blob[blob.index(b"end_header\n") + len(b"end_header\n"):]
    rec_ply = np.frombuffer(body, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    check(len(rec_ply) == len(model[2]) and np.array_equal(
        rec_ply["xyz"], np.stack([p.xyz for p in model[2].values()]).astype(
            np.float32)), "PLY round trip")

    db = os.path.join(workdir, "database.db")
    if os.path.exists(db):
        os.remove(db)
    export_scene_to_database(
        db, keypoints, match_indices, {n: (832, 832) for n in names},
        intrinsics={n: K[c] for c, n in enumerate(names)})
    with COLMAPDatabase(db) as conn:
        imgs = conn.read_images()
        kps = conn.read_keypoints()
        mts = conn.read_matches()
    by_name = {n: i for i, (n, _c) in imgs.items()}
    check(set(by_name) == set(names), "database images")
    for n in names:
        k = kps[by_name[n]]
        check(np.array_equal(k[:, :2], np.asarray(keypoints[n], np.float32)
                             + np.float32(0.5)), "database keypoints", n)
    for (a, b), m in match_indices.items():
        ia, ib = by_name[a], by_name[b]
        got = mts[(min(ia, ib), max(ia, ib))]
        want = np.asarray(m, np.uint32)
        check(np.array_equal(got, want if ia < ib else want[:, ::-1]),
              "database matches", a, b, image_ids_to_pair_id(ia, ib))

    smaller = Reconstruction.from_colmap(*rec.to_colmap())
    smaller.deregister(ids[names[-1]])
    best = model_select.best_model([None, smaller, rec])
    check(best == 2, "best_model", best)
    return dict(n_points=len(rec.points), n_observations=rec.n_observations(),
                mean_reproj_px=mean_err, best_model=best,
                stats=model_select.model_stats(rec))


def _warm_up(backend, jobs):
    """One small call of each estimator family; returns its wall time."""
    t0 = time.time()
    two_view(backend, jobs, Timer())
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(1, 64, 3)) + [0, 0, 5]).astype(np.float32)
    x = (X[..., :2] / X[..., 2:]).astype(np.float32)
    from detectorfreesfm_tpu_torch.utils.prng import stable_rngs

    r = backend.pnp(X, x, np.ones((1, 64), bool), stable_rngs([("w",)]),
                    np.full(1, 1e-3, np.float32), 16)
    backend.refine(r["q"][0], r["t"][0], X[0], x[0], r["inliers"][0])
    args, kw, _K = ba_synthetic(8, 50, seed=0)
    backend.ba(args, dict(kw, max_iters=1))
    backend.ba(args, dict(kw, max_iters=1, schur_mode="pcg"))
    return time.time() - t0


def geometry_phase(keypoints, match_indices):
    """The slice beneath the mapper on the card, from the main path's fused
    matches: match store, two-view verification, tracks and
    triangulation, registration, bundle adjustment, model store."""
    from detectorfreesfm_tpu_torch.data import h5io
    from detectorfreesfm_tpu_torch.sfm import tracks as tracks_mod

    t_phase = time.time()
    laps, last = {}, [t_phase]

    def lap(name):  # wall time of each part of the phase, in order
        now = time.time()
        laps[name] = now - last[0]
        last[0] = now

    card = PortGeometry("cuda")
    steps = {}
    workdir = os.path.join(REPO, "build", "smoke_geometry")
    os.makedirs(workdir, exist_ok=True)

    def step(name, t0, timer, **extra):
        wall = time.time() - t0
        steps[name] = dict(card_s=wall, calls_s=timer.seconds,
                           host_s=wall - timer.seconds,
                           host_share=(wall - timer.seconds) / max(wall, 1e-9),
                           **extra)

    # 1. Match store.
    t0, timer = time.time(), Timer()
    kp_path = os.path.join(workdir, "keypoints.h5")
    mt_path = os.path.join(workdir, "matches.h5")
    written = (h5io.save_h5(keypoints, kp_path),
               h5io.save_h5({f"{a}|{b}": m for (a, b), m in
                             match_indices.items()}, mt_path))
    check(written == (h5io.stored_path(kp_path), h5io.stored_path(mt_path)),
          "stored_path", written)
    kp_back = h5io.load_h5(kp_path)
    mt_back = h5io.load_h5(mt_path)
    check(kp_back.keys() == keypoints.keys() and all(
        kp_back[k].dtype == keypoints[k].dtype
        and np.array_equal(kp_back[k], keypoints[k]) for k in keypoints),
        "keypoints round trip")
    check(all(np.array_equal(mt_back[f"{a}|{b}"], m) and
              mt_back[f"{a}|{b}"].dtype == np.asarray(m).dtype
              for (a, b), m in match_indices.items()), "matches round trip")
    demo_kps = h5io.load_h5(os.path.join(DEMO_832, "keypoints.h5"), False)
    demo_raw = h5io.load_h5(os.path.join(DEMO_832, "matches.h5"), False)
    demo_matches = {tuple(k.split("|")): v.astype(np.int32)
                    for k, v in demo_raw.items()}
    check(len(demo_kps) == 8 and len(demo_matches) == 28, "demo cache")
    step("match_store", t0, timer, files=[os.path.basename(w)
                                          for w in written])

    # 2. Two-view verification, (a) synthetic and (b) demo_cached_832.
    lap("match_store")
    names, K, q, t, jobs_a = synthetic_inputs(keypoints, match_indices)
    jobs_b = demo_inputs(demo_kps, demo_matches)
    lap("inputs")
    # First calls (cuSOLVER/cuBLAS handles, lazy kernel loading, torch.func
    # tracing), timed apart from the steps.
    steps["warmup"] = dict(card_s=_warm_up(card, jobs_b[:1]))
    lap("warmup")
    res = {}
    for tag, jobs in (("a", jobs_a), ("b", jobs_b)):
        t0, timer = time.time(), Timer()
        res[tag], (x0, *_rest) = two_view(card, jobs, timer)
        step(f"two_view_{tag}", t0, timer, pairs=len(jobs),
             n_pad=int(x0.shape[1]))
    lap("two_view")
    profile = _profile_two_view(card, jobs_b[:2])
    lap("two_view_profile")

    # 3. Tracks and triangulation.
    t0, timer, tri_timer = time.time(), Timer(), Timer()
    ids, tracks = scene_tracks(card, names, keypoints, res["a"], timer)
    native = tracks_mod.last_builder == "native"
    check(native, "native track builder", tracks_mod.last_builder)
    py_tracks = card.tracks(
        {ids[n]: len(keypoints[n]) for n in names},
        {(ids[k.split("|")[0]], ids[k.split("|")[1]]): v["matches"]
         for k, v in res["a"].items() if v["kept"]}, "python")
    check([tr.observations for tr in tracks]
          == [tr.observations for tr in py_tracks], "native vs python tracks")
    pts = triangulate(card, tracks, ids, keypoints, K, q, t, names,
                      tri_timer)
    timer.seconds += tri_timer.seconds
    step("tracks_triangulation", t0, timer, n_tracks=len(tracks),
         n_points=len(pts), triangulate_calls_s=tri_timer.seconds)

    lap("tracks_triangulation")
    # 4. Registration.
    t0, timer = time.time(), Timer()
    reg = register(card, tracks, ids, keypoints, K, q, t, names, timer)
    step("registration", t0, timer)

    lap("registration")
    # 5. Bundle adjustment.
    args, kw = ba_four_view(pts, ids, K, q, t, names, keypoints)
    ba = {}
    t0 = time.time()
    out_i, info_i = card.ba(args, kw)
    card_i = time.time() - t0
    out_i2, _ = card.ba(args, kw)
    ba["i"] = dict(cameras=4, points=len(args[3]), observations=len(args[4]),
                   card_s=card_i, cost_per_obs=out_i[4],
                   rerun_cost_diff=abs(out_i2[4] - out_i[4]),
                   rerun_max_point_diff=float(np.abs(out_i2[3]
                                                     - out_i[3]).max()),
                   **info_i)
    # BA's sums are deterministic: a rerun gives the same bits.
    check(ba["i"]["rerun_cost_diff"] == 0.0
          and ba["i"]["rerun_max_point_diff"] == 0.0, "BA (i) rerun differs",
          ba["i"]["rerun_cost_diff"], ba["i"]["rerun_max_point_diff"])
    lap("ba_i")
    args2, kw2, _K2 = ba_synthetic(60, 15000, seed=3)
    lap("ba_ii_problem")
    kw2 = dict(kw2, max_iters=15)
    sol = {}
    for mode in ("dense", "pcg"):
        t0 = time.time()
        sol[mode] = card.ba(args2, dict(kw2, schur_mode=mode))
        ba[f"ii_{mode}"] = dict(cameras=60, points=len(args2[3]),
                                observations=len(args2[4]),
                                card_s=time.time() - t0,
                                cost_per_obs=sol[mode][0][4], **sol[mode][1])
    (qd, td, _i, _p, cd), (qp, tp, _i2, _p2, cp) = sol["dense"][0], \
        sol["pcg"][0]
    check(np.allclose(cd, cp, rtol=0.1, atol=1e-3)
          and np.allclose(qd, qp, atol=2e-3) and np.allclose(td, tp,
                                                             atol=2e-2),
          "BA (ii) dense vs PCG", cd, cp, float(np.abs(qd - qp).max()),
          float(np.abs(td - tp).max()))
    lap("ba_ii")
    args3, kw3, K3 = ba_synthetic(250, 60000, seed=4)
    lap("ba_iii_problem")
    t0 = time.time()
    out3, info3 = card.ba(args3, dict(kw3, max_iters=15))
    err3 = mean_reproj_every_25th(out3[0], out3[1], out3[3], args3[4],
                                  args3[5], args3[6], K3)
    ba["iii"] = dict(cameras=250, points=len(args3[3]),
                     observations=len(args3[4]), card_s=time.time() - t0,
                     cost_per_obs=out3[4], mean_reproj_px=err3, **info3)
    check(info3["solver"] == "pcg" and err3 < 1.0, "BA (iii)", info3, err3)

    lap("ba_iii")
    # 6. Model store.
    t0 = time.time()
    store = _model_store(pts, ids, names, K, keypoints, match_indices, out_i,
                         workdir)
    steps["model_store"] = dict(card_s=time.time() - t0, **store)

    got = gated_numbers(res["a"], res["b"], names, q, t, tracks, pts, reg,
                        out_i[4])
    lap("model_store")
    report = dict(geometry_s=time.time() - t_phase, laps=laps,
                  native_trackbuilder=native, steps=steps, ba=ba,
                  registration=reg, got=got, jax=JAX_GEOMETRY,
                  two_view_profile=profile)
    # The full report, kept also when a gate below fails.
    with open(os.path.join(workdir, "geometry.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)
    _check_gates(got, JAX_GEOMETRY)
    return report


def _profile_two_view(backend, jobs):
    """Device time by kernel of the two-view step's essential RANSAC, on
    the pairs given (CUPTI's cost grows with the launches: two pairs'
    1 024 QRs take about 10 s to trace, all 28 pairs' about 110 s)."""
    from torch.profiler import ProfilerActivity, profile

    x0, x1, mask, thr, keys_e, _ = verify_batch(jobs)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            backend.relpose(x0, x1, mask, keys_e, thr, N_HYP)
            torch.cuda.synchronize()
    except RuntimeError as e:  # no CUPTI tracing on this machine
        return {"not_measured": repr(e)}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)[:12]
    return dict(
        pairs=len(jobs),
        device_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
        kernel_launches=sum(e.count for e in kernels),
        top_kernels=[(e.key[:80], e.count, e.self_device_time_total / 1e3)
                     for e in top],
        top_ops=[(e.key, e.count, e.device_time_total / 1e3,
                  e.cpu_time_total / 1e3) for e in ops])


# ---------------------------------------------------------------------------
# The sfm phase: the incremental mapper and two refinement iterations on the
# card. Inputs: (a) the main path's merged matches with the true intrinsics
# and without, (b) demo_cached_832 and (c) demo_cached (416 px) from the npz
# copies in tests/data/torch/, (d) refinement of (a)'s known-intrinsics
# model on the main path's images with the r4 refiner. The JAX numbers were
# recorded through sfm_reference() with the JAX package's mapper and
# refinement (`python tests/test_torch_mapper.py --record`, on the CPU).
# ---------------------------------------------------------------------------

REFINER_WEIGHTS = os.path.join(REPO, "weights",
                               "demo_refiner_r4_bf16.msgpack")
DEMO_416 = os.path.join(REPO, "tests", "data", "torch", "demo_cached")
SFM_REFINE_ITERS = 2

# The JAX package's numbers on the same inputs (recorded on the CPU, one
# device; the refinement took 1287 s there).
JAX_SFM = {'a_known': {'mean_reproj_px': 0.6774333983607213,
             'median_rot_err_deg': 0.011017380027398214,
             'n_points': 8667,
             'registered': ['view_0', 'view_1', 'view_2', 'view_3'],
             'rot_err_deg': {'view_0': 0.0,
                             'view_1': 0.009410772067900069,
                             'view_2': 0.01262398798689636,
                             'view_3': 0.02845509790515406}},
 'a_unknown': {'mean_reproj_px': 0.8764254034401175,
               'median_rot_err_deg': 4.6170957360619145,
               'n_points': 8654,
               'registered': ['view_0', 'view_1', 'view_2', 'view_3'],
               'rot_err_deg': {'view_0': 0.0,
                               'view_1': 3.7871327419988585,
                               'view_2': 10.856113865994361,
                               'view_3': 5.447058730124971}},
 'b': {'mean_reproj_px': 2.7890114200199227,
       'n_points': 1193,
       'registered': ['00318781_8039756060.jpg',
                      '01606161_5223112207.jpg',
                      '02786360_4030483701.jpg',
                      '02928139_3448003521.jpg',
                      '03599123_13889501361.jpg',
                      '04398000_3306414527.jpg',
                      '04408102_2916920065.jpg',
                      '04477856_4856961901.jpg']},
 'c': {'mean_reproj_px': 5.301961139816039,
       'n_points': 495,
       'registered': ['00318781_8039756060.jpg',
                      '01606161_5223112207.jpg',
                      '02786360_4030483701.jpg',
                      '02928139_3448003521.jpg',
                      '03599123_13889501361.jpg',
                      '04398000_3306414527.jpg',
                      '04408102_2916920065.jpg',
                      '04477856_4856961901.jpg']},
 'd': {'counts': [{'completed': 12,
                   'filtered': 57,
                   'merged': 10,
                   'tracks': 8667},
                  {'completed': 0,
                   'filtered': 616,
                   'merged': 0,
                   'tracks': 8653}],
       'error': None,
       'iterations_completed': 2,
       'mean_reproj_px': 0.978155923891749,
       'median_rot_err_deg': 0.0448428173181411,
       'median_shift_px_0': 1.4705456095892053,
       'n_points': 8576,
       'registered': ['view_0', 'view_1', 'view_2', 'view_3'],
       'rot_err_deg': {'view_0': 0.0,
                       'view_1': 0.030862740092690053,
                       'view_2': 0.0731668789914375,
                       'view_3': 0.058822894543592144}}}


# The JAX package on the CPU from the train phase's own files, weights
# and seeds (`JAX_PLATFORMS=cpu python tests/test_torch_train.py
# --record`, 5.3 min there): per verb the step-0 loss and global gradient
# norm and every step's loss (the bootstraps' later losses as JAX prints
# them, to 4 decimals). `train` runs JAX's model and optimizer on the
# port's labels (train/supervision.py: JAX's own but for the reference
# inputs' rounding ties; `loss0_jax_labels` is JAX's own labels' loss).
JAX_TRAIN = {'matcher_selfsup': {'grad_norm0': 1.5227237939834595,
                                 'loss0': 2.1278305053710938,
                                 'losses': [2.1278, 2.3927, 2.0509]},
             'refiner_selfsup': {'grad_norm0': 2.3808767795562744,
                                 'loss0': 2.5211849212646484,
                                 'losses': [2.5212, 2.6566, 2.506]},
             'train': {'grad_norm0': 16.52646827697754,
                       'grad_norms': [16.52646827697754,
                                      13.49618148803711,
                                      13.583890914916992],
                       'loss0': 0.7565832734107971,
                       'loss0_jax_labels': 0.8215869665145874,
                       'losses': [0.7565832734107971,
                                  0.8333027958869934,
                                  0.8748477101325989],
                       'mask_agreement': 1.0,
                       'ref_inputs_on_other_tie': 172},
             'train_matcher': {'grad_norm0': 2.284970283508301,
                               'grad_norms': [2.284970283508301,
                                              5.799782752990723,
                                              1.9358047246932983],
                               'loss0': 1.0796880722045898,
                               'losses': [1.0796880722045898,
                                          1.2360594272613525,
                                          1.0619219541549683],
                               'matched_rows': 9603}}


def demo_mapper_kwargs(kps, side):
    """MapperConfig of tests/run_demo832.py (side 832) and
    tests/test_demo_golden.py (side 416): thresholds scaled by the mean
    long side over the matching resolution."""
    f = max(1.0, float(np.mean([max(DEMO_SIZES[n]) for n in kps])) / side)
    return dict(geometry_verify_thr=10 * f, init_max_error=10 * f,
                abs_pose_max_error=12 * f, filter_max_reproj_error=10 * f,
                tri_merge_max_reproj_error=10 * f,
                tri_complete_max_reproj_error=10 * f,
                abs_pose_min_num_inliers=8, refine_focal=True,
                min_model_size=3, min_tri_angle_deg=1.0)


def model_numbers(rec, names=None, q=None):
    """Registered names, points and mean reprojection error of a model;
    with the true rotations q (in `names` order), each registered image's
    rotation error in degrees relative to the first registered image."""
    if rec is None:
        return dict(registered=[], n_points=0, mean_reproj_px=float("inf"))
    errs = np.concatenate(list(rec.reprojection_errors().values()))
    out = dict(registered=sorted(rec.images[i].name
                                 for i in rec.registered_images),
               n_points=len(rec.points), mean_reproj_px=float(errs.mean()))
    if q is not None:
        reg = sorted(rec.registered_images)
        R_true = _rotmat(q)
        a = reg[0]
        Ra, Ta = _rotmat(rec.images[a].qvec), R_true[names.index(
            rec.images[a].name)]
        rot = {}
        for i in reg:
            c = names.index(rec.images[i].name)
            rot[rec.images[i].name] = _angle_deg(
                (_rotmat(rec.images[i].qvec) @ Ra.T) @ (R_true[c] @ Ta.T).T)
        out["rot_err_deg"] = rot
        out["median_rot_err_deg"] = float(np.median(list(rot.values())))
    return out


def demo_caches():
    """{tag: (keypoints, matches, side)} of the two cached demo scenes."""
    from detectorfreesfm_tpu_torch.data.h5io import load_h5

    out = {}
    for tag, d, side in (("b", DEMO_832, 832), ("c", DEMO_416, 416)):
        kps = load_h5(os.path.join(d, "keypoints.h5"), False)
        raw = load_h5(os.path.join(d, "matches.h5"), False)
        out[tag] = (kps, {tuple(k.split("|")): v.astype(np.int32)
                          for k, v in raw.items()}, side)
    return out


def sfm_reference(backend, keypoints, match_indices, demo):
    """The gated numbers of the sfm phase through one backend (the port's
    mapper and refinement, or the JAX package's), with each run's report.
    `backend.mapper(**cfg)` makes a mapper; `backend.refine(rec, images,
    mapper)` refines in place and returns its info dict."""
    from detectorfreesfm_tpu_torch.data.synthetic import (
        SyntheticConfig,
        generate_scene,
    )

    imgs, _d, K, q, _t = generate_scene(0, SyntheticConfig(size=832,
                                                           n_views=4))
    names = [f"view_{i}" for i in range(4)]
    sizes = {n: (832, 832) for n in names}
    got, report, models = {}, {}, {}
    for tag, intr in (("a_known", {n: K[i] for i, n in enumerate(names)}),
                      ("a_unknown", None)):
        mapper = backend.mapper()
        t0 = time.time()
        rec = mapper.run(keypoints, match_indices, sizes, intr)
        report[tag] = dict(wall_s=time.time() - t0,
                           steps_s=dict(getattr(mapper, "times", {})),
                           calls=dict(getattr(mapper, "calls", {})))
        got[tag] = model_numbers(rec, names, q)
        models[tag] = (rec, mapper)
    for tag, (kps, matches, side) in demo.items():
        mapper = backend.mapper(**demo_mapper_kwargs(kps, side))
        t0 = time.time()
        rec = mapper.run(kps, matches, {n: DEMO_SIZES[n] for n in kps}, None)
        report[tag] = dict(wall_s=time.time() - t0,
                           steps_s=dict(getattr(mapper, "times", {})),
                           calls=dict(getattr(mapper, "calls", {})))
        got[tag] = model_numbers(rec)
    rec, mapper = models["a_known"]
    images = {rec.image_by_name(n).id: imgs[i] for i, n in enumerate(names)}
    t0 = time.time()
    info = backend.refine(rec, images, mapper)
    its = info["iterations"]
    report["d"] = dict(wall_s=time.time() - t0, **info)
    got["d"] = dict(
        model_numbers(rec, names, q),
        iterations_completed=info["iterations_completed"],
        error=info["error"],
        median_shift_px_0=its[0]["median_shift_px"] if its else None,
        counts=[dict(tracks=i["tracks"], merged=i["merged"],
                     completed=i["completed"], filtered=i["filtered"])
                for i in its])
    return got, report


class PortSfm:
    """The port's mapper and refinement on one device."""

    def __init__(self, device):
        from detectorfreesfm_tpu_torch.utils.checkpoint import (
            load_refiner_params,
        )

        self.device = device
        self.params = load_refiner_params(REFINER_WEIGHTS, device=device)

    def mapper(self, **cfg):
        from detectorfreesfm_tpu_torch.sfm.mapper import (
            IncrementalMapper,
            MapperConfig,
        )

        return IncrementalMapper(MapperConfig(**cfg), device=self.device)

    def refine(self, rec, images, mapper):
        from detectorfreesfm_tpu_torch.refine.loop import (
            RefineConfig,
            refine_reconstruction,
        )

        info = {}
        refine_reconstruction(rec, images, self.params,
                              RefineConfig(n_iters=SFM_REFINE_ITERS),
                              mapper=mapper, device=self.device, info=info)
        return info


def _check_sfm_gates(got, ref):
    """Hold the card's mapper and refinement numbers to the JAX package's."""
    for tag in ("a_known", "a_unknown"):
        g, r = got[tag], ref[tag]
        check(g["registered"] == r["registered"], tag, "registered",
              g["registered"], r["registered"])
        check(abs(g["n_points"] - r["n_points"]) <= 0.01 * r["n_points"],
              tag, "points", g["n_points"], r["n_points"])
        check(abs(g["mean_reproj_px"] - r["mean_reproj_px"]) <= 0.05, tag,
              "mean reprojection", g["mean_reproj_px"], r["mean_reproj_px"])
        for n, e in g["rot_err_deg"].items():
            check(abs(e - r["rot_err_deg"][n]) <= 0.05, tag, "rotation", n,
                  e, r["rot_err_deg"][n])
    g, r = got["b"], ref["b"]
    check(len(g["registered"]) == 8 and g["n_points"] >= 1000
          and g["mean_reproj_px"] < 5.0, "b: demo_cached_832 bars", g)
    check(g["registered"] == r["registered"]
          and abs(g["n_points"] - r["n_points"]) <= 0.02 * r["n_points"],
          "b: against JAX", g, r)
    g = got["c"]
    check(len(g["registered"]) >= 4 and g["n_points"] >= 200
          and g["mean_reproj_px"] < 8.0, "c: demo_cached bars", g)
    g, r = got["d"], ref["d"]
    check(g["iterations_completed"] == SFM_REFINE_ITERS and g["error"] is None,
          "d: refinement iterations", g["iterations_completed"], g["error"])
    check(len(g["registered"]) == len(r["registered"]), "d: registered",
          g["registered"], r["registered"])
    check(abs(g["n_points"] - r["n_points"]) <= 0.02 * r["n_points"],
          "d: points", g["n_points"], r["n_points"])
    check(abs(g["mean_reproj_px"] - r["mean_reproj_px"]) <= 0.05,
          "d: mean reprojection", g["mean_reproj_px"], r["mean_reproj_px"])
    check(abs(g["median_rot_err_deg"] - r["median_rot_err_deg"]) <= 0.05,
          "d: median rotation", g["median_rot_err_deg"],
          r["median_rot_err_deg"])
    check(abs(g["median_shift_px_0"] - r["median_shift_px_0"])
          <= 0.05 * r["median_shift_px_0"], "d: median shift of iteration 0",
          g["median_shift_px_0"], r["median_shift_px_0"])


def sfm_phase(keypoints, match_indices):
    """The mapper and refinement on the card from the main path's matches
    and the cached demo matches; held to JAX_SFM."""
    t_phase = time.time()
    workdir = os.path.join(REPO, "build", "smoke_sfm")
    os.makedirs(workdir, exist_ok=True)
    t0 = time.time()
    backend = PortSfm("cuda")
    load_s = time.time() - t0
    got, report = sfm_reference(backend, keypoints, match_indices,
                                demo_caches())
    summary = dict(sfm_summary(report), sfm_s=time.time() - t_phase,
                   refiner_load_s=load_s)
    full = dict(summary, got=got, jax=JAX_SFM, report=report)
    # The full report, kept also when a gate below fails.
    with open(os.path.join(workdir, "sfm.json"), "w") as f:
        json.dump(full, f, indent=1, default=float)
    _check_sfm_gates(got, JAX_SFM)
    return dict(summary, got=got)


def sfm_summary(report):
    """What the sfm phase prints: the mapper's seconds per step and per
    run, and per refinement iteration the refiner's device ms per chunk,
    the geometry refinement's seconds and the merge/complete/filter
    counts."""
    d = report["d"]
    return dict(
        mapper_steps_s={k: v["steps_s"] for k, v in report.items()
                        if k != "d"},
        mapper_wall_s={k: v["wall_s"] for k, v in report.items()
                       if k != "d"},
        refine=[dict(tracks=i["tracks"], window=i["window"],
                     chunks=i["chunks"],
                     forward_ms_per_chunk=float(np.median(i["forward_ms"])),
                     forward_ms_total=float(np.sum(i["forward_ms"])),
                     match_s=i["match_s"], geometry_s=i["geometry_s"],
                     merged=i["merged"], completed=i["completed"],
                     filtered=i["filtered"]) for i in d["iterations"]],
        refine_wall_s=d["wall_s"])


# ---------------------------------------------------------------------------
# The reconstruct phase: the `reconstruct` verb, as a user runs it, on PNG
# files written to disk, held to the JAX package's own `cli reconstruct`
# on the same files (`python tests/test_torch_pipeline.py --record`, on the
# CPU: dense matching, batch 1, the JAX CLI's defaults off the TPU).
# ---------------------------------------------------------------------------

RECON_SIZE = 1040          # rendered larger than the 832 px network frame
RECON_VIEWS = 4
RECON_SCALE_VIEWS = 6      # run C: 15 pairs (cut from 16, then 12 and 8,
                           # to make room for the train and eval phases,
                           # PERF.md §4)
RECON_BATCH = 8            # the verb's batch default on the card
STAGE_KEYS = ("match", "coarse_sfm", "io", "refine")

# The JAX package's `cli reconstruct` on the CPU from the same PNG files
# (1068 s there; its stage times: match 36.41 s, coarse_sfm 29.65 s, io
# 1.19 s, refine 962.74 s).
JAX_RECONSTRUCT = {'coarse': {'grey_fraction': 0.008070510778379527,
                              'mean_reproj_px': 0.8659090934902437,
                              'n_observations': 20558,
                              'n_points': 9417,
                              'registered': ['view_000.png',
                                             'view_001.png',
                                             'view_002.png',
                                             'view_003.png']},
                   'refined': {'grey_fraction': 0.009235115167318557,
                               'mean_reproj_px': 1.2088134577399503,
                               'n_observations': 19751,
                               'n_points': 9204,
                               'registered': ['view_000.png',
                                              'view_001.png',
                                              'view_002.png',
                                              'view_003.png']},
                   'result': {'n_images': 4,
                              'n_observations': 19751,
                              'n_points': 9204,
                              'n_registered': 4,
                              'pose_auc': {'auc@1': 0.9321375260616918,
                                           'auc@10': 0.9932137526061693,
                                           'auc@20': 0.9966068763030845,
                                           'auc@3': 0.9773791753538972,
                                           'auc@5': 0.9864275052123384},
                              'status': 'ok'}}


def write_scene(root, seed=0, size=RECON_SIZE, n_views=RECON_VIEWS):
    """generate_scene as a scene directory of the CLI's layout:
    images/view_00k.png (8-bit gray, written by data/png.py with
    adaptive row filters, as photographs are written),
    poses/view_00k.txt (4x4 world-to-camera) and intrins/view_00k.txt
    (3x3 K). Returns the image names and the true (K, q, t)."""
    from detectorfreesfm_tpu_torch.data.png import write_png
    from detectorfreesfm_tpu_torch.data.synthetic import (
        SyntheticConfig,
        generate_scene,
        quat_to_rotmat,
    )

    imgs, _d, K, q, t = generate_scene(
        seed, SyntheticConfig(size=size, n_views=n_views))
    for sub in ("images", "poses", "intrins"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = []
    for i in range(n_views):
        stem = f"view_{i:03d}"
        names.append(stem + ".png")
        write_png(os.path.join(root, "images", stem + ".png"),
                  np.clip(np.round(imgs[i] * 255.0), 0, 255).astype(np.uint8))
        pose = np.eye(4)
        pose[:3, :3] = quat_to_rotmat(q[i])
        pose[:3, 3] = t[i]
        np.savetxt(os.path.join(root, "poses", stem + ".txt"), pose)
        np.savetxt(os.path.join(root, "intrins", stem + ".txt"), K[i])
    return names, K, q, t


def run_reconstruct(cli_main, scene, out, *extra):
    """One `reconstruct --scene scene --output out` through a CLI's main()
    in this process (the port's, or the JAX package's when recording).
    Returns its JSON result line with reconstruct_numbers(out), and the
    run's stage times and wall seconds."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["reconstruct", "--scene", scene, "--output", out,
                       *extra])
    wall = time.time() - t0
    printed = buf.getvalue()
    check(rc == 0, "reconstruct exit code", rc, printed[-2000:])
    result = json.loads(printed.strip().splitlines()[-1])
    with open(os.path.join(out, "stage_times.json")) as f:
        stages = json.load(f)
    return (dict(result=result, **reconstruct_numbers(out)),
            dict(stage_times=stages, wall_s=wall))


def reconstruct_numbers(out_dir):
    """What the reconstruct gates compare, read back from a run's output
    directory: per model (colmap_coarse, colmap_refined) the registered
    names, points, observations, mean reprojection error and the share of
    points left grey (128, 128, 128)."""
    from detectorfreesfm_tpu_torch.data import colmap_io
    from detectorfreesfm_tpu_torch.sfm.reconstruction import Reconstruction

    out = {}
    for tag in ("coarse", "refined"):
        cams, imgs, pts = colmap_io.read_model(
            os.path.join(out_dir, f"colmap_{tag}"))
        errs = Reconstruction.from_colmap(cams, imgs, pts
                                          ).reprojection_errors()
        e = np.concatenate(list(errs.values())) if errs else np.zeros(0)
        rgb = np.stack([p.rgb for p in pts.values()]) if pts else None
        out[tag] = dict(
            registered=sorted(im.name for im in imgs.values()),
            n_points=len(pts),
            n_observations=int(sum(len(p.image_ids) for p in pts.values())),
            mean_reproj_px=float(e.mean()) if e.size else float("inf"),
            grey_fraction=(float((rgb == 128).all(axis=1).mean())
                           if rgb is not None else 1.0))
    return out


RECON_FILES = (
    "colmap_coarse/cameras.bin", "colmap_coarse/images.bin",
    "colmap_coarse/points3D.bin", "colmap_refined/cameras.bin",
    "colmap_refined/images.bin", "colmap_refined/points3D.bin",
    "model_refined_0/images.bin", "model_refined_1/images.bin",
    "colmap_refined/points.ply", "colmap_refined/cameras_points.ply",
    "database.db", "stage_times.json")


def written_files(out):
    """What a run with two refinement iterations must leave in `out`: the
    models, PLYs, database and stage times, and the match stores at the
    path the store writes (h5io.stored_path). Returns what is missing."""
    from detectorfreesfm_tpu_torch.pipeline import match_stores
    from detectorfreesfm_tpu_torch.data.h5io import stored_path

    missing = [f for f in RECON_FILES
               if not os.path.exists(os.path.join(out, f))]
    missing += [stored_path(p) for p in match_stores(out)
                if not os.path.exists(stored_path(p))]
    path = os.path.join(out, "stage_times.json")
    if os.path.exists(path):
        with open(path) as f:
            keys = set(json.load(f))
        missing += [f"stage_times.json:{k}" for k in STAGE_KEYS
                    if k not in keys]
    return missing


def _check_model_gates(got, ref, where):
    """Hold the models of one run of the verb (reconstruct_numbers, and
    its result line) to the JAX CLI's on the same files: two refinement
    iterations, the same registered sets, coarse points within 1%,
    refined points and observations within 2%, mean reprojection within
    0.05 px, and points coloured."""
    check(got["result"]["status"] == "ok"
          and got["result"].get("refine_iterations_completed") == 2,
          where, "status", got["result"])
    g, r = got["coarse"], ref["coarse"]
    check(g["registered"] == r["registered"], where, "coarse: registered",
          g["registered"], r["registered"])
    check(abs(g["n_points"] - r["n_points"]) <= 0.01 * r["n_points"],
          where, "coarse: points", g["n_points"], r["n_points"])
    g, r = got["refined"], ref["refined"]
    check(g["registered"] == r["registered"], where, "refined: registered",
          g["registered"], r["registered"])
    for k in ("n_points", "n_observations"):
        check(abs(g[k] - r[k]) <= 0.02 * r[k], where, "refined:", k, g[k],
              r[k])
    check(abs(g["mean_reproj_px"] - r["mean_reproj_px"]) <= 0.05,
          where, "refined: mean reprojection", g["mean_reproj_px"],
          r["mean_reproj_px"])
    check(g["grey_fraction"] < 0.5, where, "refined: grey points",
          g["grey_fraction"])


def _check_reconstruct_gates(got, ref):
    """Hold run A of the verb on the card to the JAX CLI's numbers."""
    check(got["launches"] == {"dsm_pass1": 1, "dsm_pass2": 1},
          "reconstruct: kernel launches", got["launches"])
    check(not got["missing_files"], "reconstruct: files missing",
          got["missing_files"])
    _check_model_gates(got, ref, "reconstruct")
    a, b = got["result"]["pose_auc"], ref["result"]["pose_auc"]
    check(abs(a["auc@5"] - b["auc@5"]) <= 0.02, "AUC@5", a, b)


def _match_timing(engine, image_dir, names, repeats=3):
    """Warm seconds of the engine's whole match stage (decode, batches,
    merge) over the scene's exhaustive pairs: the median of `repeats`."""
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs

    pairs = exhaustive_pairs(names)
    paths = {n: os.path.join(image_dir, n) for n in names}
    engine.match_scene(pairs, paths)  # warm-up (cuDNN timing, decode)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.time()
        engine.match_scene(pairs, paths)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return float(np.median(times)), times


def _filter_counts(path):
    """How many rows of a PNG file use each of the five row filters."""
    import zlib

    from detectorfreesfm_tpu_torch.data import png

    with open(path, "rb") as f:
        data = f.read()
    idat = b"".join(b for k, b in png._chunks(data, path) if k == b"IDAT")
    h = png.png_size(data, path)[1]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return np.bincount(rows[:, 0], minlength=5).tolist()


def _decode_timing(paths, work):
    """Seconds to decode and resize the images to the 832 px frame (the
    backend images.load_gray picks), one after another and through the
    8-thread pool the engine and the pipeline use, with the row filters
    the files hold. Then, on the first file, data/png.py's C++ unfilter
    against its Python fallback; and a 2080 px RGB file with adaptive
    filters (2x2 tiles of three views as its colour channels), decoded
    and resized as a user's photograph would be."""
    from concurrent.futures import ThreadPoolExecutor

    from detectorfreesfm_tpu_torch.data import images, png

    def load(p):
        return images.load_gray(p, 832, 8, 832)

    t0 = time.time()
    serial = [load(p) for p in paths]
    serial_s = time.time() - t0
    backend, unfilter = images.last_backend, png.last_unfilter
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=8) as pool:
        pooled = list(pool.map(load, paths))
    pooled_s = time.time() - t0
    check(all(np.array_equal(a.data, b.data) for a, b in zip(serial, pooled)),
          "threaded decode differs")
    with open(paths[0], "rb") as f:
        data = f.read()
    unfilter_s = {}
    for how in ("native", "python"):
        t0 = time.time()
        px = png.decode_png(data, paths[0], unfilter=how).pixels
        unfilter_s[how] = time.time() - t0
        check(np.array_equal(px, png.read_png(paths[0]).pixels),
              "unfilter", how)
    views = [png.read_png(p).pixels for p in paths[:3]]
    rgb = np.tile(np.stack(views, -1), (2, 2, 1))
    big = os.path.join(work, "rgb_2080px.png")
    png.write_png(big, rgb)
    t0 = time.time()
    big_img = load(big)
    big_s = time.time() - t0
    check(big_img.valid_size == (832, 832), "2080 px resize",
          big_img.valid_size)
    return dict(images=len(paths), backend=backend, unfilter=unfilter,
                unfilter_error=png.native_error(),
                row_filters=_filter_counts(paths[0]),
                serial_s=serial_s, threads_8_s=pooled_s,
                first_image_decode_s=unfilter_s,
                rgb_2080px=dict(bytes=os.path.getsize(big),
                                row_filters=_filter_counts(big),
                                load_gray_s=big_s))


def reconstruct_phase():
    """The `reconstruct` verb on the card, as a user calls it, on a scene
    written to disk: run A (gated against JAX_RECONSTRUCT), run B (a
    resuming rerun in a subprocess) and run C (6 views, report-only
    apart from completion); fused against dense matching at 832 px, and
    image decoding serial against the verb's 8 threads."""
    import dataclasses
    import shutil

    from detectorfreesfm_tpu_torch import cli, pipeline
    from detectorfreesfm_tpu_torch.data import images
    from detectorfreesfm_tpu_torch.data.h5io import stored_path
    from detectorfreesfm_tpu_torch.match.engine import PairMatchingEngine
    from detectorfreesfm_tpu_torch.ops import fused_dsm

    t_phase = time.time()
    work = os.path.join(REPO, "build", "smoke_reconstruct")
    shutil.rmtree(work, ignore_errors=True)
    scene = os.path.join(work, "scene")
    out = os.path.join(work, "out")
    t0 = time.time()
    names, _K, _q, _t = write_scene(scene)
    write_s = time.time() - t0

    # Run A: the verb in this process, every option at its default but
    # --fused on, so that the kernels are on the path.
    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0
    images.last_backend = None
    got, run_a = run_reconstruct(cli.main, scene, out, "--fused", "on")
    got["launches"] = dict(fused_dsm.launches)
    got["missing_files"] = written_files(out)
    backend = images.last_backend
    stores = [stored_path(p) for p in pipeline.match_stores(out)]
    mtimes = [os.path.getmtime(p) for p in stores if os.path.exists(p)]

    # Fused against dense at 832 px: the match stage of the verb's own
    # engine (batch 8), warm, and a dense twin with the same weights.
    (_key, fused_engine), = pipeline._ENGINE_CACHE.items()
    dense_engine = PairMatchingEngine(
        dataclasses.replace(fused_engine.cfg, fused_matching=False),
        params=fused_engine.model.state_dict(), device="cuda")
    image_dir = os.path.join(scene, "images")
    fused_s, fused_runs = _match_timing(fused_engine, image_dir, names)
    dense_s, dense_runs = _match_timing(dense_engine, image_dir, names)
    del dense_engine

    # Run B: the same command as a user's rerun, in a subprocess. It must
    # read the stored matches and models, and not load the matcher.
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "detectorfreesfm_tpu_torch.cli",
         "reconstruct", "--scene", scene, "--output", out, "--fused", "on"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    b_wall = time.time() - t0
    check(proc.returncode == 0, "run B exit code", proc.returncode,
          proc.stderr[-2000:])
    result_b = json.loads(proc.stdout.strip().splitlines()[-1])
    run_b = dict(wall_s=b_wall, result=result_b,
                 loaded_matcher="matcher weights" in proc.stderr,
                 stores_rewritten=[os.path.getmtime(p) for p in stores]
                 != mtimes)

    # Run C: RECON_SCALE_VIEWS views through the same verb.
    scene_c = os.path.join(work, "scene_c")
    out_c = os.path.join(work, "out_c")
    names_c, _K, _q, _t = write_scene(scene_c, n_views=RECON_SCALE_VIEWS)
    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0
    got_c, run_c = run_reconstruct(cli.main, scene_c, out_c, "--fused", "on")
    run_c.update(launches=dict(fused_dsm.launches),
                 missing_files=written_files(out_c), result=got_c["result"],
                 coarse=got_c["coarse"], refined=got_c["refined"])
    pipeline._ENGINE_CACHE.clear()
    decode = _decode_timing([os.path.join(scene_c, "images", n)
                             for n in names_c], work)

    n_pairs_c = RECON_SCALE_VIEWS * (RECON_SCALE_VIEWS - 1) // 2
    n_batches_c = -(-n_pairs_c // RECON_BATCH)
    report = dict(
        reconstruct_s=time.time() - t_phase, write_scene_s=write_s,
        image_backend=backend, native_image_loader=images.native_error()
        is None, native_error=images.native_error(),
        run_a=dict(run_a, launches=got["launches"],
                   n_registered=got["result"]["n_registered"],
                   n_points=got["result"]["n_points"],
                   pose_auc=got["result"].get("pose_auc")),
        match_832px=dict(batch=fused_engine.cfg.batch_size, pairs=len(names)
                         * (len(names) - 1) // 2, fused_s=fused_s,
                         dense_s=dense_s, fused_runs=fused_runs,
                         dense_runs=dense_runs),
        decode_1040px=decode,
        run_b=run_b,
        run_c=dict(views=RECON_SCALE_VIEWS, pairs=n_pairs_c,
                   stage_times=run_c["stage_times"], wall_s=run_c["wall_s"],
                   launches=run_c["launches"],
                   n_registered=got_c["result"].get("n_registered"),
                   n_points=got_c["result"].get("n_points"),
                   pose_auc=got_c["result"].get("pose_auc")),
        got=got, got_c=got_c, jax=JAX_RECONSTRUCT)
    # The full report, kept also when a gate below fails.
    with open(os.path.join(work, "reconstruct.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)
    _check_reconstruct_gates(got, JAX_RECONSTRUCT)
    check(not run_b["loaded_matcher"] and not run_b["stores_rewritten"],
          "run B matched again", run_b)
    check(result_b["n_registered"] == got["result"]["n_registered"]
          and result_b["n_points"] == got["result"]["n_points"],
          "run B differs from run A", result_b, got["result"])
    check(got_c["result"]["status"] == "ok"
          and got_c["result"]["refine_iterations_completed"] == 2
          and not run_c["missing_files"],
          "run C", got_c["result"], run_c["missing_files"])
    check(decode["unfilter"] == "native", "C++ unfilter", decode)
    check(run_c["launches"] == {"dsm_pass1": n_batches_c,
                                "dsm_pass2": n_batches_c},
          "run C launches", run_c["launches"])
    return {k: v for k, v in report.items()
            if k not in ("got", "got_c", "jax")}


# ---------------------------------------------------------------------------
# The train phase: the four training verbs through the port's cli.main on
# two rendered scenes written to disk, each step's loss and gradient norm
# held to the JAX package's on the same files (JAX_TRAIN, recorded on the
# CPU with `JAX_PLATFORMS=cpu python tests/test_torch_train.py --record`).
# ---------------------------------------------------------------------------

TRAIN_SCENE = dict(size=832, n_views=6, tuple_size=4, n_tuples=8)
TRAIN_STEPS = 3
REFINER_W = os.path.join(REPO, "weights", "demo_refiner_r4_bf16.msgpack")
# Relative tolerances: step 0 where both packages start from the same
# parameters, later steps after Adam steps, and the fresh-init refiner
# bootstrap (different draws). Tightened from 1e-3 / 1e-3 / 2e-2 after the
# first card run (PERF.md: step-0 losses within 5e-6, gradient norms
# within 4.2e-4, later losses within 4e-5).
TRAIN_TOL = dict(loss0=1e-4, grad_norm0=1e-3, later=2e-3, fresh=0.25)



def write_train_data(root):
    """Two rendered scenes (seeds 0 and 1) in the trainers' index layout
    under root/data; returns (data dir, scene 0's image dir)."""
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          write_scene)

    data = os.path.join(root, "data")
    for seed in (0, 1):
        write_scene(data, f"scene{seed}", seed, SyntheticConfig(**TRAIN_SCENE))
    return data, os.path.join(data, "scene0", "images")


def train_argv(data, images, out):
    """verb name -> the command line of the phase (and of the record)."""
    return {
        "train_matcher": [
            "train-matcher", "--data", data, "--output",
            os.path.join(out, "matcher"), "--fine", "--img-resize", "832",
            "--init-ckpt", WEIGHTS, "--batch-size", "1", "--max-steps",
            str(TRAIN_STEPS), "--log-every", "1"],
        "train": [
            "train", "--data", data, "--output", os.path.join(out, "refiner"),
            "--img-resize", "832", "--window", "15", "--n-tracks", "200",
            "--init-ckpt", REFINER_W, "--batch-size", "1", "--max-steps",
            str(TRAIN_STEPS), "--log-every", "1"],
        "matcher_selfsup": [
            "train-matcher-selfsup", "--images", images, "--output",
            os.path.join(out, "matcher_selfsup.msgpack"), "--init-ckpt",
            WEIGHTS, "--steps", str(TRAIN_STEPS), "--log-every", "1"],
        "refiner_selfsup": [
            "train-refiner-selfsup", "--images", images, "--output",
            os.path.join(out, "refiner_selfsup.msgpack"), "--steps",
            str(TRAIN_STEPS), "--log-every", "1"],
    }


def train_checkpoint(name, out):
    return {"train_matcher": os.path.join(out, "matcher",
                                          "matcher_ep0.msgpack"),
            "train": os.path.join(out, "refiner", "ckpt_ep0.msgpack"),
            "matcher_selfsup": os.path.join(out, "matcher_selfsup.msgpack"),
            "refiner_selfsup": os.path.join(out, "refiner_selfsup.msgpack"),
            }[name]


def read_back(name, path):
    """The checkpoint through the port's loaders, strictly: every leaf the
    trainer's tree has, and nothing else."""
    from detectorfreesfm_tpu_torch.models.loftr import (DetectorFreeMatcher,
                                                        MatcherConfig)
    from detectorfreesfm_tpu_torch.utils import checkpoint as ck

    if name in ("train", "refiner_selfsup"):
        return ck.load_refiner_params(path, device="cuda")
    state = ck.flax_variables_to_state_dict(ck.read_variables(path))
    with torch.device("meta"):
        want = DetectorFreeMatcher(MatcherConfig()).state_dict()
    if name == "matcher_selfsup":
        want = {k: v for k, v in want.items()
                if not k.startswith(ck.FINE_PREFIX)}
    ck.match_state_dict(state, want)
    return state


def profile_train_step(data):
    """torch.profiler of one steady `train-matcher --fine` step (r5 warm
    start, the verb's first batch): forward/backward/optimizer split and
    the top kernels. Returns the report and the trainer's params."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from detectorfreesfm_tpu_torch import cli
    from detectorfreesfm_tpu_torch.models.loftr import MatcherConfig
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        MatcherTrainConfig, MatcherTrainer, tuple_to_pair_batch)
    from detectorfreesfm_tpu_torch.train.optimizers import OptimConfig
    from detectorfreesfm_tpu_torch.train.trainer import value_and_grad

    args = cli.argparse.Namespace(data=data, img_resize=832,
                                  samples_per_scene=200)
    datasets, sampler, _w = cli._datasets(args)
    s, t = sampler.epoch(0)[0]
    batch = tuple_to_pair_batch([datasets[s][t]])
    tr = MatcherTrainer(MatcherTrainConfig(
        matcher=MatcherConfig(fine_enabled=True),
        optim=OptimConfig(true_batch_size=1)), device="cuda")
    state = tr.init_state(batch)
    state = state._replace(params=tr.load_params(WEIGHTS, state.params))
    for _ in range(2):
        state, _loss = tr.train_step(state, batch)
    torch.cuda.synchronize()
    gt, uv1 = tr.supervise(batch)
    im0 = torch.as_tensor(batch["image0"], device="cuda")
    im1 = torch.as_tensor(batch["image1"], device="cuda")
    t0 = time.time()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("labels"):
                gt, uv1 = tr.supervise(batch)
            with record_function("forward_backward"):
                loss, grads = value_and_grad(
                    tr.model, state.params, lambda apply: tr.loss_one(
                        apply, im0[0], im1[0], gt[0], uv1[0]))
            with record_function("optimizer"):
                state.opt_state.step(state.params, grads)
            torch.cuda.synchronize()
    except RuntimeError as e:
        return {"not_measured": repr(e)}
    wall_ms = (time.time() - t0) * 1e3
    events = prof.key_averages()
    names = ("labels", "forward_backward", "optimizer")
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in names]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    ranges = {e.key: dict(cpu_ms=e.cpu_time_total / 1e3,
                          device_ms=e.device_time_total / 1e3)
              for e in events if e.key in names
              and e.device_type == torch.autograd.DeviceType.CPU}
    bwd = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and "Backward" in e.key]
    return dict(wall_ms=wall_ms, device_ms=dev_ms, ranges=ranges,
                loss=float(loss), backward_named_ms=sum(
                    e.self_device_time_total for e in bwd) / 1e3,
                top=[(e.key[:90], e.count, e.self_device_time_total / 1e3)
                     for e in top])


def serve_trained_matcher(path):
    """The trained matcher checkpoint through the engine with the fused
    kernels on main's 6 pairs, held to the dense path with the same
    weights: launches as on main, IoU >= 0.95."""
    from detectorfreesfm_tpu_torch.data.images import from_array
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)
    from detectorfreesfm_tpu_torch.match.engine import (EngineConfig,
                                                        PairMatchingEngine)
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs
    from detectorfreesfm_tpu_torch.ops import fused_dsm
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params

    imgs, _d, _K, _q, _t = generate_scene(0, SyntheticConfig(size=832,
                                                             n_views=4))
    names = [f"view_{i}" for i in range(len(imgs))]
    images = {n: from_array(imgs[i]) for i, n in enumerate(names)}
    pairs = exhaustive_pairs(names)
    params = load_matcher_params(path)

    def engine(fused):
        return PairMatchingEngine(EngineConfig(
            img_resize=832, fine_enabled=True, round_matches_ratio=4,
            fused_matching=fused, batch_size=2), params)

    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0
    fused = engine(True).match_pairs(pairs, images)
    launches = dict(fused_dsm.launches)
    dense = engine(False).match_pairs(pairs, images)
    ious = {f"{a}-{b}": iou(row_set(fused[(a, b)]), row_set(dense[(a, b)]))
            for a, b in pairs}
    return dict(launches=launches, iou_fused_vs_dense=ious,
                valid=sum(len(m["conf"]) for m in fused.values()))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _check_train_gates(got, ref):
    for name in ("train_matcher", "train", "matcher_selfsup"):
        g, r = got[name], ref[name]
        check(_rel(g["losses"][0], r["loss0"]) <= TRAIN_TOL["loss0"],
              name, "step-0 loss", g["losses"][0], r["loss0"])
        check(_rel(g["grad_norms"][0], r["grad_norm0"])
              <= TRAIN_TOL["grad_norm0"], name, "step-0 gradient norm",
              g["grad_norms"][0], r["grad_norm0"])
        for i in range(1, TRAIN_STEPS):
            check(_rel(g["losses"][i], r["losses"][i]) <= TRAIN_TOL["later"],
                  name, f"step-{i} loss", g["losses"][i], r["losses"][i])
    g, r = got["refiner_selfsup"], ref["refiner_selfsup"]
    check(all(np.isfinite(g["losses"])), "refiner_selfsup losses",
          g["losses"])
    check(_rel(g["losses"][0], r["loss0"]) <= TRAIN_TOL["fresh"],
          "refiner_selfsup step-0 loss", g["losses"][0], r["loss0"])


def train_phase():
    """The four training verbs on the card (see the section comment);
    full report in build/smoke_train/train.json."""
    import shutil

    from detectorfreesfm_tpu_torch import cli
    from detectorfreesfm_tpu_torch.ops import fused_dsm

    t_phase = time.time()
    work = os.path.join(REPO, "build", "smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.time()
    data, images = write_train_data(work)
    write_s = time.time() - t0
    out = os.path.join(work, "out")
    report = dict(write_data_s=write_s, verbs={})
    for name, argv in train_argv(data, images, out).items():
        log = os.path.join(work, f"{name}.jsonl")
        for k in fused_dsm.launches:
            fused_dsm.launches[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        rc = cli.main(argv + ["--log-json", log])
        wall = time.time() - t0
        check(rc == 0, name, "exit code", rc)
        with open(log) as f:
            steps = [json.loads(ln) for ln in f]
        check(len(steps) == TRAIN_STEPS, name, "steps", len(steps))
        secs = [s["seconds"] for s in steps]
        path = train_checkpoint(name, out)
        n_leaves = len(read_back(name, path))
        report["verbs"][name] = dict(
            argv=argv, wall_s=wall, first_step_s=secs[0],
            steady_median_s=float(np.median(secs[1:])),
            max_memory_allocated_gib=torch.cuda.max_memory_allocated()
            / 2 ** 30, losses=[s["loss"] for s in steps],
            grad_norms=[s["grad_norm"] for s in steps],
            launches=dict(fused_dsm.launches), checkpoint_leaves=n_leaves,
            jax=JAX_TRAIN[name])
    t0 = time.time()
    report["profile_train_matcher_step"] = profile_train_step(data)
    report["profile_s"] = time.time() - t0
    t0 = time.time()
    report["serve"] = serve_trained_matcher(
        train_checkpoint("train_matcher", out))
    report["serve_s"] = time.time() - t0
    report["train_s"] = time.time() - t_phase
    with open(os.path.join(work, "train.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)
    got = report["verbs"]
    for name, g in got.items():
        check(g["launches"] == {"dsm_pass1": 0, "dsm_pass2": 0},
              name, "fused kernels launched while training", g["launches"])
    _check_train_gates(got, JAX_TRAIN)
    serve = report["serve"]
    check(serve["launches"] == {"dsm_pass1": 3, "dsm_pass2": 3},
          "trained matcher's launches", serve["launches"])
    check(min(serve["iou_fused_vs_dense"].values()) >= 0.95,
          "trained matcher fused vs dense IoU", serve["iou_fused_vs_dense"])
    summary = {k: v for k, v in report.items() if k != "verbs"}
    summary["verbs"] = {n: {k: v for k, v in g.items()
                            if k not in ("argv", "jax")}
                        for n, g in got.items()}
    return summary


# ---------------------------------------------------------------------------
# The eval phase: the `eval-dataset` verb in known-pose triangulation mode
# (the ETH3D protocol) on a two-scene dataset written as PNG, held to the
# JAX package's own `cli eval-dataset` on the same files (JAX_EVAL,
# recorded on the CPU with `JAX_PLATFORMS=cpu python
# tests/test_torch_eval_dataset.py --record`); its isolated rerun; and the
# first scene again at 1600 px through both kernels, scored against the
# scene's true surface.
# ---------------------------------------------------------------------------

EVAL_SIZE = 2000           # written larger than both network frames
EVAL_VIEWS = 4
EVAL_SCENES = (("s0_3bag", 0), ("s1_3bag", 1))  # (name, seed)
EVAL_ARGS = ("--triangulation", "--known-intrinsics", "--imc-bags")
ETH3D_RESIZE = 1600
ETH3D_B8_SHAPE = dict(b=8, l=40000, s=40000, c=256)  # the verb's batch
PC_TOLERANCES = (0.02, 0.05, 0.1)  # world units; the scene spans 4-12
SURFACE_STRIDE = 16        # true surface: every 16th pixel of each view

# The JAX package's `cli eval-dataset` on the CPU from the same PNG files
# (3181 s there; stage times match / coarse_sfm / io / refine:
# s0_3bag 54.4 / 15.43 / 3.84 / 1484.76 s, s1_3bag 82.96 / 15.58 / 2.13 /
# 1443.61 s).
JAX_EVAL = {
    "metrics": {
        "3bag": {
            "auc@1": 1.0,
            "auc@10": 1.0,
            "auc@20": 1.0,
            "auc@3": 1.0,
            "auc@5": 1.0,
            "registered_ratio": 1.0,
            "wall_s": 1590.5
        },
        "all": {
            "auc@1": 1.0,
            "auc@10": 1.0,
            "auc@20": 1.0,
            "auc@3": 1.0,
            "auc@5": 1.0,
            "registered_ratio": 1.0,
            "wall_s": 1590.5
        },
        "per_scene": {
            "s0_3bag": {
                "auc@1": 1.0,
                "auc@10": 1.0,
                "auc@20": 1.0,
                "auc@3": 1.0,
                "auc@5": 1.0,
                "registered_ratio": 1.0,
                "wall_s": 1621.5
            },
            "s1_3bag": {
                "auc@1": 1.0,
                "auc@10": 1.0,
                "auc@20": 1.0,
                "auc@3": 1.0,
                "auc@5": 1.0,
                "registered_ratio": 1.0,
                "wall_s": 1559.5
            }
        }
    },
    "scenes": {
        "s0_3bag": {
            "coarse": {
                "grey_fraction": 0.008283433133732535,
                "mean_reproj_px": 0.864900021613546,
                "n_observations": 21655,
                "n_points": 10020,
                "registered": [
                    "view_000.png",
                    "view_001.png",
                    "view_002.png",
                    "view_003.png"
                ]
            },
            "refined": {
                "grey_fraction": 0.008784773060029283,
                "mean_reproj_px": 2.040012851469021,
                "n_observations": 21352,
                "n_points": 9562,
                "registered": [
                    "view_000.png",
                    "view_001.png",
                    "view_002.png",
                    "view_003.png"
                ]
            },
            "result": {
                "n_images": 4,
                "n_observations": 21352,
                "n_points": 9562,
                "n_registered": 4,
                "pose_auc": {
                    "auc@1": 0.9999926016417895,
                    "auc@10": 0.999999260164179,
                    "auc@20": 0.9999996300820895,
                    "auc@3": 0.9999975338805965,
                    "auc@5": 0.9999985203283579
                },
                "status": "ok"
            }
        },
        "s1_3bag": {
            "coarse": {
                "grey_fraction": 0.011860940695296524,
                "mean_reproj_px": 0.8405331244374745,
                "n_observations": 21254,
                "n_points": 9780,
                "registered": [
                    "view_000.png",
                    "view_001.png",
                    "view_002.png",
                    "view_003.png"
                ]
            },
            "refined": {
                "grey_fraction": 0.011383812010443865,
                "mean_reproj_px": 2.1381783973213238,
                "n_observations": 20898,
                "n_points": 9575,
                "registered": [
                    "view_000.png",
                    "view_001.png",
                    "view_002.png",
                    "view_003.png"
                ]
            },
            "result": {
                "n_images": 4,
                "n_observations": 20898,
                "n_points": 9575,
                "n_registered": 4,
                "pose_auc": {
                    "auc@1": 0.9999889158164018,
                    "auc@10": 0.9999988915816402,
                    "auc@20": 0.9999994457908201,
                    "auc@3": 0.999996305272134,
                    "auc@5": 0.9999977831632803
                },
                "status": "ok"
            }
        }
    }
}


def write_eval_dataset(root):
    """EVAL_SCENES written by write_scene at EVAL_SIZE px under root, the
    scenes rendered in parallel threads. Returns {scene: (names, K, q,
    t)}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(EVAL_SCENES)) as pool:
        done = {name: pool.submit(write_scene, os.path.join(root, name),
                                  seed=seed, size=EVAL_SIZE,
                                  n_views=EVAL_VIEWS)
                for name, seed in EVAL_SCENES}
    return {name: f.result() for name, f in done.items()}


def parse_metrics(text):
    """metrics.txt (eval/aggregate.py::format_report) -> {group: {key:
    value}}, the per-scene lines under "per_scene"; a warning line is kept
    as a key with the value None."""
    groups, cur = {}, None
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("[") and s.endswith("]"):
            cur = groups.setdefault(s[1:-1], {})
        elif s.startswith("---- per scene"):
            cur = None
            groups["per_scene"] = {}
        elif s.startswith("(warning"):
            cur[s] = None
        elif cur is not None and ": " in s:
            k, v = s.split(": ")
            cur[k] = float(v)
        elif "per_scene" in groups and ": " in s:
            scene, body = s.split(": ", 1)
            groups["per_scene"][scene] = {
                k: float(v) for k, v in
                (kv.split("=") for kv in body.split(", "))}
    return groups


def without_wall(metrics):
    """parse_metrics' groups without the wall_s keys (timing, not result)."""
    def strip(d):
        return {k: v for k, v in d.items() if k != "wall_s"}

    return {g: ({s: strip(m) for s, m in v.items()} if g == "per_scene"
                else strip(v))
            for g, v in metrics.items()}


def run_eval_dataset(cli_main, dataset, out, *extra):
    """One `eval-dataset --dataset dataset --output out` through a CLI's
    main() in this process. Returns the per-scene result lines with
    reconstruct_numbers of each scene's output and the parsed metrics.txt,
    and the run's wall seconds and per-scene stage times."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["eval-dataset", "--dataset", dataset, "--output", out,
                       *extra])
    wall = time.time() - t0
    printed = buf.getvalue()
    check(rc == 0, "eval-dataset exit code", rc, printed[-2000:])
    scenes, runs = {}, {}
    for line in printed.splitlines():
        if not line.startswith('{"scene"'):
            continue
        res = json.loads(line)
        s, w = res.pop("scene"), res.pop("wall_s")
        scenes[s] = dict(result=res)
        if res.get("status") == "ok":
            scenes[s].update(reconstruct_numbers(os.path.join(out, s)))
        path = os.path.join(out, s, "stage_times.json")
        stages = None
        if os.path.exists(path):
            with open(path) as f:
                stages = json.load(f)
        runs[s] = dict(wall_s=w, stage_times=stages)
    with open(os.path.join(out, "metrics.txt")) as f:
        metrics = parse_metrics(f.read())
    return (dict(scenes=scenes, metrics=metrics),
            dict(wall_s=wall, scenes=runs))


def true_surface(seed, size=160):
    """The scene's true surface as points: every pixel of generate_scene's
    z-depth maps of the scene of `seed`, back-projected into the world. The
    geometry (planes, poses, focal as a share of the frame) does not
    depend on the rendered size, so a small render samples the same
    surface (4 x 160^2 points)."""
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene,
                                                          quat_to_rotmat)

    _imgs, depths, K, q, t = generate_scene(
        seed, SyntheticConfig(size=size, n_views=EVAL_VIEWS))
    ys, xs = np.mgrid[0:size, 0:size] + 0.5
    pts = []
    for v in range(EVAL_VIEWS):
        d = depths[v]
        ok = d > 0
        ray = np.stack([(xs[ok] - K[v, 0, 2]) / K[v, 0, 0],
                        (ys[ok] - K[v, 1, 2]) / K[v, 1, 1],
                        np.ones(ok.sum())], -1)
        R = quat_to_rotmat(q[v])
        pts.append((ray * d[ok][:, None] - t[v]) @ R)  # R^T (X_c - t)
    return np.concatenate(pts)


def model_points(model_dir):
    """(N, 3) points of a written model."""
    from detectorfreesfm_tpu_torch.data import colmap_io

    _c, _i, pts = colmap_io.read_model(model_dir)
    return np.stack([p.xyz for p in pts.values()])


def pose_errors(model_dir, scene_dir):
    """Largest |qvec - q| and |tvec - t| of a written model's images
    against the scene's poses/ files (the sign of q fixed by the file's)."""
    from detectorfreesfm_tpu_torch.data import colmap_io
    from detectorfreesfm_tpu_torch.pipeline import read_pose_txt

    _c, imgs, _p = colmap_io.read_model(model_dir)
    dq = dt = 0.0
    for im in imgs.values():
        q, t = read_pose_txt(os.path.join(
            scene_dir, "poses", os.path.splitext(im.name)[0] + ".txt"))
        dq = max(dq, float(np.abs(im.qvec - q * np.sign(q @ im.qvec)).max()))
        dt = max(dt, float(np.abs(im.tvec - t).max()))
    return dict(n_images=len(imgs), qvec=dq, tvec=dt)


def check_kernels_1600_b8(seed=4):
    """Both passes at the verb's batch of 8 at 1600 px (L = S = 40 000),
    the shape E3 launches: each pair held to the plain version at B = 1
    (the plain (L, S) matrices of 8 pairs do not fit), then both timed at
    B = 8 against the bound."""
    from detectorfreesfm_tpu_torch.ops import fused_dsm as K

    shape = ETH3D_B8_SHAPE
    f0, f1, m0, m1 = features(seed=seed, **shape)
    ops = K.split_features(f0, f1, m0, m1, 0.1)
    del f0, f1
    lse_r, lse_c = K.dsm_pass1(*ops)
    rmax, rarg, cmax, carg = K.dsm_pass2(*ops, lse_r, lse_c)
    err_lse = err_max = 0.0
    agree = 1.0
    plain_ms = None
    for b in range(shape["b"]):
        one = [x[b:b + 1] for x in ops]
        mb0, mb1 = m0[b:b + 1], m1[b:b + 1]
        pr, pc = K.dsm_pass1_plain(*one)
        err_lse = max(err_lse, (lse_r[b:b + 1] - pr)[mb0].abs().max().item(),
                      (lse_c[b:b + 1] - pc)[mb1].abs().max().item())
        del pr, pc
        p_rmax, p_rarg, p_cmax, p_carg = K.dsm_pass2_plain(
            *one, lse_r[b:b + 1], lse_c[b:b + 1])
        err_max = max(err_max,
                      (rmax[b:b + 1] - p_rmax)[mb0].abs().max().item(),
                      (cmax[b:b + 1] - p_cmax)[mb1].abs().max().item())
        agree = min(agree,
                    (rarg[b:b + 1] == p_rarg)[mb0].float().mean().item(),
                    (carg[b:b + 1] == p_carg)[mb1].float().mean().item())
        del p_rmax, p_rarg, p_cmax, p_carg
        if b == 0:
            plain_ms = dict(
                dsm_pass1=cuda_ms(lambda: K.dsm_pass1_plain(*one), 2),
                dsm_pass2=cuda_ms(lambda: K.dsm_pass2_plain(
                    *one, lse_r[:1], lse_c[:1]), 2))
        torch.cuda.empty_cache()
    check(err_lse <= 2e-3, "1600 px B=8 dsm_pass1 vs plain", err_lse)
    check(agree >= 0.995, "1600 px B=8 argmax agreement", agree)
    out = dict(shape=shape, lse_max_abs_err=err_lse,
               argmax_max_abs_err=err_max, arg_agree=agree)
    for name, fn, pass2, err in (
            ("dsm_pass1", lambda: K.dsm_pass1(*ops), False, err_lse),
            ("dsm_pass2", lambda: K.dsm_pass2(*ops, lse_r, lse_c), True,
             err_max)):
        bound_ms, bound_by = bound(shape, pass2)
        ms = cuda_ms(fn, 5)
        out[name] = dict(ms=ms, plain_ms_one_pair=plain_ms[name],
                         bound_ms=bound_ms, bound_by=bound_by,
                         share_of_bound=bound_ms / ms, max_abs_err=err)
    return out


def _check_eval_gates(got, ref, truth_poses):
    """Hold E1 (eval-dataset, triangulation mode, on the card) to the JAX
    CLI's eval-dataset on the same files."""
    check(sorted(got["scenes"]) == sorted(ref["scenes"]), "eval: scenes",
          sorted(got["scenes"]))
    for s, r in ref["scenes"].items():
        _check_model_gates(got["scenes"][s], r, f"eval {s}")
        e = truth_poses[s]
        check(e["n_images"] == EVAL_VIEWS and e["qvec"] <= 1e-5
              and e["tvec"] <= 1e-5, "eval: poses moved", s, e)
    for g in ("all", "3bag", "per_scene"):
        check(without_wall(got["metrics"])[g]
              == without_wall(ref["metrics"])[g], "eval: metrics.txt", g,
              got["metrics"][g], ref["metrics"][g])


def eval_phase():
    """The eval-dataset verb on the card (see the section comment): E1
    in process, E2 its isolated rerun, E3 the first scene at 1600 px through
    both kernels, and both passes at 1600 px, B = 8; full report in
    build/smoke_eval/eval.json."""
    import dataclasses
    import shutil

    from detectorfreesfm_tpu_torch import cli, pipeline
    from detectorfreesfm_tpu_torch.data.h5io import stored_path
    from detectorfreesfm_tpu_torch.eval.pointcloud import (
        accuracy_completeness,
    )
    from detectorfreesfm_tpu_torch.match.engine import PairMatchingEngine
    from detectorfreesfm_tpu_torch.ops import fused_dsm

    t_phase = time.time()
    work = os.path.join(REPO, "build", "smoke_eval")
    shutil.rmtree(work, ignore_errors=True)
    dataset = os.path.join(work, "dataset")
    t0 = time.time()
    written = write_eval_dataset(dataset)
    write_s = time.time() - t0
    scene0 = EVAL_SCENES[0][0]
    report = dict(write_dataset_s=write_s)

    # E1: the dataset in triangulation mode, in this process, at the
    # verb's defaults (832 px: --fused auto takes the dense path).
    out1 = os.path.join(work, "e1")
    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0
    got1, run1 = run_eval_dataset(cli.main, dataset, out1, *EVAL_ARGS)
    e1_launches = dict(fused_dsm.launches)
    poses1 = {s: pose_errors(os.path.join(out1, s, "colmap_refined"),
                             os.path.join(dataset, s)) for s in written}
    report["e1"] = dict(run1, launches=e1_launches, poses=poses1,
                        metrics=got1["metrics"],
                        n_points={s: g["result"].get("n_points")
                                  for s, g in got1["scenes"].items()})

    # E2: the same dataset and output with every scene in a subprocess;
    # each must resume from its stored matches and models.
    stores = [stored_path(p) for s in written
              for p in pipeline.match_stores(os.path.join(out1, s))]
    stores += [os.path.join(out1, s, "colmap_refined", "images.bin")
               for s in written]
    mtimes = [os.path.getmtime(p) for p in stores]
    got2, run2 = run_eval_dataset(cli.main, dataset, out1, *EVAL_ARGS,
                                  "--isolate-scenes", "--scene-timeout",
                                  "600")
    rewritten = [p for p, m in zip(stores, mtimes)
                 if os.path.getmtime(p) != m]
    report["e2"] = dict(run2, rewritten=rewritten)

    # E3: the first scene at 1600 px, the ETH3D protocol, through both
    # kernels (--fused auto on the card above 12 000 coarse tokens).
    out3 = os.path.join(work, "e3_1600px")
    scene_dir = os.path.join(dataset, scene0)
    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0
    pipeline._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got3, run3 = run_reconstruct(
        cli.main, scene_dir, out3, "--triangulation", "--known-intrinsics",
        "--img-resize", str(ETH3D_RESIZE), "--fused", "auto")
    torch.cuda.synchronize()
    e3_launches = dict(fused_dsm.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    (_key, engine3), = pipeline._ENGINE_CACHE.items()
    names = written[scene0][0]
    image_dir = os.path.join(scene_dir, "images")
    warm_s, _runs = _match_timing(engine3, image_dir, names, repeats=1)
    poses3 = pose_errors(os.path.join(out3, "colmap_refined"), scene_dir)

    # One pair at 1600 px through the engine at B = 1, fused against
    # dense (whose (L, S) matrices fit at one pair only).
    pipeline._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    t0 = time.time()
    pair = (names[0], names[1])
    rows = {}
    for fused in (True, False):
        eng = PairMatchingEngine(
            dataclasses.replace(engine3.cfg, batch_size=1,
                                fused_matching=fused),
            params=engine3.model.state_dict(), device="cuda")
        imgs = eng.load_images({n: os.path.join(image_dir, n) for n in pair})
        rows[fused] = row_set(eng.match_pairs([pair], imgs)[pair])
        del eng
        torch.cuda.empty_cache()
    del engine3
    iou_1600 = iou(rows[True], rows[False])
    iou_s = time.time() - t0

    # Accuracy / completeness of both scene-0 models against the true
    # surface, on the card; E3's also on the CPU.
    surface = true_surface(EVAL_SCENES[0][1])
    pts3 = model_points(os.path.join(out3, "colmap_refined"))
    pts1 = model_points(os.path.join(out1, scene0, "colmap_refined"))
    t0 = time.time()
    pc3 = accuracy_completeness(pts3, surface, PC_TOLERANCES)
    pc_card_s = time.time() - t0
    pc1 = accuracy_completeness(pts1, surface, PC_TOLERANCES)
    t0 = time.time()
    pc3_cpu = accuracy_completeness(pts3, surface, PC_TOLERANCES,
                                    device="cpu")
    pc_cpu_s = time.time() - t0
    report["e3"] = dict(
        run3, launches=e3_launches, batches=-(-len(names) * (len(names) - 1)
                                             // 2 // RECON_BATCH),
        max_memory_allocated_gib=peak_gib, warm_match_s=warm_s,
        poses=poses3, n_points=got3["result"].get("n_points"),
        result=got3["result"], refined=got3["refined"],
        iou_fused_vs_dense_1600px_b1=iou_1600, pair=list(pair),
        iou_s=iou_s,
        surface_points=len(surface), pointcloud_1600px=pc3,
        pointcloud_832px=pc1, pointcloud_1600px_cpu=pc3_cpu,
        pointcloud_card_s=pc_card_s, pointcloud_cpu_s=pc_cpu_s)
    torch.cuda.empty_cache()
    t0 = time.time()
    report["kernels_1600px_b8"] = check_kernels_1600_b8()
    report["kernels_1600px_b8_s"] = time.time() - t0
    report["eval_s"] = time.time() - t_phase
    report["got"], report["jax"] = got1, JAX_EVAL
    with open(os.path.join(work, "eval.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)

    check(JAX_EVAL is not None, "JAX_EVAL is not recorded")
    _check_eval_gates(got1, JAX_EVAL, poses1)
    check(e1_launches == {"dsm_pass1": 0, "dsm_pass2": 0},
          "E1 (832 px, --fused auto) launched the kernels", e1_launches)
    check(without_wall(got2["metrics"]) == without_wall(got1["metrics"]),
          "E2 metrics.txt differs from E1's", got2["metrics"],
          got1["metrics"])
    check(not rewritten, "E2 matched or refined again", rewritten)
    n3 = report["e3"]["batches"]
    check(e3_launches == {"dsm_pass1": n3, "dsm_pass2": n3},
          "E3 kernel launches", e3_launches, n3)
    check(got3["result"]["status"] == "ok"
          and got3["result"]["refine_iterations_completed"] == 2,
          "E3 status", got3["result"])
    check(poses3["n_images"] == EVAL_VIEWS and poses3["qvec"] <= 1e-5
          and poses3["tvec"] <= 1e-5, "E3 poses moved", poses3)
    check(iou_1600 >= 0.99, "E3 fused vs dense IoU at 1600 px", iou_1600)
    mid = f"accuracy@{PC_TOLERANCES[1]}"
    check(pc3[mid] >= pc1[mid] - 0.02, "E3 accuracy below 832 px's",
          pc3[mid], pc1[mid])
    check(all(abs(pc3[k] - pc3_cpu[k]) <= 1e-6 for k in pc3),
          "accuracy_completeness card vs CPU", pc3, pc3_cpu)
    return {k: v for k, v in report.items() if k not in ("got", "jax")}


# ---------------------------------------------------------------------------
# The bf16 phase: the JAX package's bf16 compute path on the card (the
# verbs' `--dtype bfloat16` and `--dtype-train bfloat16`), on the files
# that the reconstruct and train phases wrote, held to the JAX package's
# own bf16 runs on the CPU: JAX_RECONSTRUCT_BF16 (`python
# tests/test_torch_pipeline.py --record --dtype bfloat16`, 1259 s there;
# refinement stays fp32 in both packages), JAX_MAIN["bfloat16"] and
# JAX_TRAIN_BF16 (`python tests/test_torch_train.py --record --dtype
# bfloat16`; the JAX runs compiled without XLA's YNNPACK fusion, which
# cannot run their batched bf16 dots on the CPU).
# ---------------------------------------------------------------------------

JAX_RECONSTRUCT_BF16 = {'coarse': {'grey_fraction': 0.007974481658692184,
                                   'mean_reproj_px': 0.8707430233986009,
                                   'n_observations': 20553,
                                   'n_points': 9405,
                                   'registered': ['view_000.png',
                                                  'view_001.png',
                                                  'view_002.png',
                                                  'view_003.png']},
                        'refined': {'grey_fraction': 0.009680226234500761,
                                    'mean_reproj_px': 1.2106153892710356,
                                    'n_observations': 19730,
                                    'n_points': 9194,
                                    'registered': ['view_000.png',
                                                   'view_001.png',
                                                   'view_002.png',
                                                   'view_003.png']},
                        'result': {'n_images': 4,
                                   'n_observations': 19730,
                                   'n_points': 9194,
                                   'n_registered': 4,
                                   'pose_auc': {'auc@1': 0.9321562108332536,
                                                'auc@10': 0.9932156210833252,
                                                'auc@20': 0.9966078105416628,
                                                'auc@3': 0.9773854036110846,
                                                'auc@5': 0.9864312421666508},
                                   'status': 'ok'}}
JAX_TRAIN_BF16 = {'matcher_selfsup': {'grad_norm0': 1.5721492767333984,
                                      'loss0': 2.127548933029175,
                                      'losses': [2.1276, 2.4171, 2.06]},
                  'train_matcher': {'grad_norm0': 2.2589006423950195,
                                    'grad_norms': [2.2589006423950195,
                                                   7.0278425216674805,
                                                   1.9631216526031494],
                                    'loss0': 1.0797322988510132,
                                    'losses': [1.0797322988510132,
                                               1.2644320726394653,
                                               1.0578967332839966],
                                    'matched_rows': 9603}}


def _check_train_bf16(got, ref16, ref32):
    """The bf16 verbs' losses and gradient norms against JAX's bf16 steps,
    sized by JAX's own bf16-against-fp32 gap.

    Step 0 (no update yet): each loss and gradient norm within twice that
    gap, or bf16's unit roundoff (2^-8, relative) where that is larger;
    two bf16 runs that round in different places sit about sqrt(2) times
    that gap apart.

    Steps 1 on: Adam's first update moves every parameter by about the
    learning rate times the sign of its gradient, so rounding that flips
    a near-zero component moves it as far as a large one, and each later
    step's gap is one draw of a heavy-tailed spread, not a scale (JAX's
    bf16 and fp32 train-matcher part by 21% in step 1's gradient norm and
    1.4% in step 2's; the port's own fp32 step-2 norm is 0.35% from
    JAX's). So these steps are held as one vector per quantity, by the
    relative-norm criterion of the CPU parity tests: e(port, JAX bf16) <=
    e(JAX bf16, JAX fp32) and e(port, JAX fp32) <= 1.5 e(JAX bf16, JAX
    fp32), e the norm of the difference over the norm of JAX fp32's.

    Returns each quantity's (port, JAX bf16, JAX fp32, tolerance) for
    step 0 and (e(port, bf16), e(bf16, fp32), e(port, fp32)) for the later
    steps."""
    out = {}
    for name in ("train_matcher", "matcher_selfsup"):
        g, r16, r32 = got[name], ref16[name], ref32[name]
        for what, p, j16, j32 in (
                ("loss 0", g["losses"][0], r16["loss0"], r32["loss0"]),
                ("grad_norm 0", g["grad_norms"][0], r16["grad_norm0"],
                 r32["grad_norm0"])):
            tol = max(2.0 * abs(j16 - j32), 2.0 ** -8 * abs(j32))
            out[f"{name} {what}"] = (p, j16, j32, tol)
            check(abs(p - j16) <= tol, "bf16", name, what, p, j16, j32, tol)
        later = [("losses", g["losses"], r16["losses"], r32["losses"])]
        if "grad_norms" in r16:
            later.append(("grad_norms", g["grad_norms"], r16["grad_norms"],
                          r32["grad_norms"]))
        for what, p, j16, j32 in later:
            p, j16, j32 = (np.asarray(v[1:TRAIN_STEPS], np.float64)
                           for v in (p, j16, j32))
            scale = np.linalg.norm(j32)
            e16, gap, e32 = (float(np.linalg.norm(a - b) / scale)
                             for a, b in ((p, j16), (j16, j32), (p, j32)))
            what = f"{what} 1-{TRAIN_STEPS - 1}"
            out[f"{name} {what}"] = (e16, gap, e32)
            check(e16 <= gap and e32 <= 1.5 * gap, "bf16", name, what,
                  dict(port=p.tolist(), jax_bf16=j16.tolist(),
                       jax_fp32=j32.tolist(), e_port_bf16=e16,
                       e_bf16_fp32=gap, e_port_fp32=e32))
    return out


def bf16_phase(params, fp32_main, recon, train):
    """The bf16 path on the card (see the section comment): the main
    path's 6 pairs, both passes on bf16-derived features, run A with
    --dtype bfloat16, and the two matcher trainers with --dtype-train
    bfloat16; against the fp32 phases' numbers of this run. Full report
    in build/smoke_bf16/bf16.json."""
    import shutil

    from detectorfreesfm_tpu_torch import cli, pipeline
    from detectorfreesfm_tpu_torch.ops import fused_dsm

    t_phase = time.time()
    work = os.path.join(REPO, "build", "smoke_bf16")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    report = {}

    t0 = time.time()
    report["kernels_bf16_features"] = check_kernels(VERB_SHAPE, seed=3,
                                                    timed=True, bf16=True)
    report["kernels_s"] = time.time() - t0

    t0 = time.time()
    _kps, _mi, main16 = main_path(params, "bfloat16")
    report["main"] = main16
    report["main_s"] = time.time() - t0
    report["main_pairs_per_s"] = dict(
        float32=fp32_main["fused_pairs_per_s"],
        bfloat16=main16["fused_pairs_per_s"])

    # Run A with --dtype bfloat16 on the reconstruct phase's scene.
    scene = os.path.join(REPO, "build", "smoke_reconstruct", "scene")
    out = os.path.join(work, "out_a")
    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0
    got, run_a = run_reconstruct(cli.main, scene, out, "--fused", "on",
                                 "--dtype", "bfloat16")
    got["launches"] = dict(fused_dsm.launches)
    got["missing_files"] = written_files(out)
    (_key, engine), = pipeline._ENGINE_CACHE.items()
    names = sorted(os.listdir(os.path.join(scene, "images")))
    fused_s, fused_runs = _match_timing(engine, os.path.join(scene,
                                                             "images"), names)
    pipeline._ENGINE_CACHE.clear()
    del engine
    report["run_a"] = dict(
        run_a, launches=got["launches"],
        n_registered=got["result"]["n_registered"],
        n_points=got["result"]["n_points"],
        pose_auc=got["result"].get("pose_auc"),
        jax_n_points=JAX_RECONSTRUCT_BF16["result"]["n_points"],
        jax_pose_auc=JAX_RECONSTRUCT_BF16["result"]["pose_auc"])
    report["match_832px_warm_s"] = dict(
        float32=recon["match_832px"]["fused_s"], bfloat16=fused_s,
        bfloat16_runs=fused_runs)

    # The two matcher trainers on the train phase's files.
    data = os.path.join(REPO, "build", "smoke_train", "data")
    images = os.path.join(data, "scene0", "images")
    argv = train_argv(data, images, os.path.join(work, "train"))
    report["train"] = {}
    for name in ("train_matcher", "matcher_selfsup"):
        log = os.path.join(work, f"{name}.jsonl")
        for k in fused_dsm.launches:
            fused_dsm.launches[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        rc = cli.main(argv[name] + ["--dtype-train", "bfloat16",
                                    "--log-json", log])
        wall = time.time() - t0
        check(rc == 0, "bf16", name, "exit code", rc)
        with open(log) as f:
            steps = [json.loads(ln) for ln in f]
        check(len(steps) == TRAIN_STEPS, "bf16", name, "steps", len(steps))
        back = read_back(name, train_checkpoint(name, os.path.join(
            work, "train")))
        secs = [s["seconds"] for s in steps]
        report["train"][name] = dict(
            wall_s=wall, first_step_s=secs[0],
            steady_median_s=float(np.median(secs[1:])),
            max_memory_allocated_gib=torch.cuda.max_memory_allocated()
            / 2 ** 30,
            fp32_max_memory_allocated_gib=train["verbs"][name][
                "max_memory_allocated_gib"],
            losses=[s["loss"] for s in steps],
            grad_norms=[s["grad_norm"] for s in steps],
            launches=dict(fused_dsm.launches), checkpoint_leaves=len(back),
            checkpoint_fp32=all(v.dtype == torch.float32
                                for v in back.values()))
    report["bf16_s"] = time.time() - t_phase
    with open(os.path.join(work, "bf16.json"), "w") as f:
        json.dump(dict(report, got=got), f, indent=1, default=float)

    _check_reconstruct_gates(got, JAX_RECONSTRUCT_BF16)
    check(main16["launches"] == {"dsm_pass1": 3, "dsm_pass2": 3},
          "bf16 main launches", main16["launches"])
    for name, g in report["train"].items():
        check(g["launches"] == {"dsm_pass1": 0, "dsm_pass2": 0},
              "bf16", name, "fused kernels launched while training",
              g["launches"])
        check(g["checkpoint_fp32"], "bf16", name, "checkpoint not fp32")
    report["train_gates"] = _check_train_bf16(report["train"],
                                              JAX_TRAIN_BF16, JAX_TRAIN)
    return report


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from detectorfreesfm_tpu_torch.device import set_fp32_backends
    from detectorfreesfm_tpu_torch.ops import _build, fused_dsm
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params

    set_fp32_backends()  # plain versions' matmuls in full fp32, as the kernels
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        smi = "nvidia-smi not available"
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.time()
    so = _build.build(fused_dsm.SOURCE)
    _build.load(fused_dsm.SOURCE)
    build_s = time.time() - t0
    hgmma = _build.sass_count(so, "HGMMA")
    log = so.with_suffix(".log").read_text() if so.with_suffix(
        ".log").exists() else ""
    emit({"phase": "build", "seconds": build_s, "library": so.name,
          "hgmma_instructions": hgmma,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Performance Loss" in ln]})
    check(hgmma > 0, "no HGMMA instruction: the product is not on the "
          "tensor cores")
    # The native image loader (g++ with -ljpeg -lpng): whether this machine
    # has the headers and libraries. The verb reads PNG with data/png.py
    # either way; without the library a JPEG raises (ROADMAP item 18).
    # data/png.py's C++ unfilter needs g++ only, and must build.
    from detectorfreesfm_tpu_torch.data import images, png

    t0 = time.time()
    native = images._load_native() is not None
    unfilter = png._load_native() is not None
    emit({"phase": "build_image_loader", "seconds": time.time() - t0,
          "native_image_loader": native, "error": images.native_error(),
          "library": images.library_path().name,
          "png_unfilter": unfilter, "png_unfilter_error": png.native_error()})
    check(unfilter, "C++ PNG unfilter did not build", png.native_error())

    t0 = time.time()
    ragged = check_kernels(RAGGED_SHAPE, seed=1, timed=False)
    main_k = check_kernels(MAIN_SHAPE, seed=0, timed=True)
    verb_k = check_kernels(VERB_SHAPE, seed=3, timed=True)
    eth3d = check_kernels(ETH3D_SHAPE, seed=2, timed=True)
    ties = check_ties()
    emit({"phase": "kernels", "seconds": time.time() - t0,
          "ragged": ragged, "main_shape": main_k, "verb_shape": verb_k,
          "eth3d_1600px": eth3d, "ties": ties})

    t0 = time.time()
    params = load_matcher_params(WEIGHTS)
    n_params = sum(v.numel() for k, v in params.items()
                   if not k.endswith(("running_mean", "running_var")))
    check(n_params == N_PARAMS_R5, "parameter count", n_params)
    emit({"phase": "weights", "seconds": time.time() - t0,
          "n_params": n_params})

    t0 = time.time()
    keypoints, match_indices, main_res = main_path(params)
    emit({"phase": "main", "seconds": time.time() - t0, **main_res})

    geo = geometry_phase(keypoints, match_indices)
    emit({"phase": "geometry", **geo})

    sfm = sfm_phase(keypoints, match_indices)
    emit({"phase": "sfm", **sfm})

    recon = reconstruct_phase()
    emit({"phase": "reconstruct", **recon})

    train = train_phase()
    emit({"phase": "train", **train})

    ev = eval_phase()
    emit({"phase": "eval", **ev})
    k1600 = ev["kernels_1600px_b8"]

    b16 = bf16_phase(params, main_res, recon, train)
    emit({"phase": "bf16", **b16})

    replaces = {
        "dsm_pass1": "detectorfreesfm_tpu/ops/pallas_dsm.py:98 (_pass1_kernel)",
        "dsm_pass2": "detectorfreesfm_tpu/ops/pallas_dsm.py:160 "
                     "(_pass2_kernel)",
    }
    src = "detectorfreesfm_tpu_torch/csrc/dual_softmax.cu"
    kernels = []
    for kname in ("dsm_pass1", "dsm_pass2"):
        # Run A's launches are at VERB_SHAPE: its check, time and bound.
        k = verb_k[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces[kname],
            "launches": recon["run_a"]["launches"][kname],
            "launches_by_path": {
                "main": main_res["launches"][kname],
                "reconstruct_a": recon["run_a"]["launches"][kname],
                "reconstruct_c": recon["run_c"]["launches"][kname],
                **{f"train_{n}": g["launches"][kname]
                   for n, g in train["verbs"].items()},
                "train_serve": train["serve"]["launches"][kname],
                "eval_e1": ev["e1"]["launches"][kname],
                "eval_e3_1600px": ev["e3"]["launches"][kname],
                "bf16_main": b16["main"]["launches"][kname],
                "bf16_reconstruct_a": b16["run_a"]["launches"][kname],
                **{f"bf16_train_{n}": g["launches"][kname]
                   for n, g in b16["train"].items()}},
            "shape": verb_k["shape"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "ms_at_main_shape": main_k[kname]["ms"],
            "shape_1600px_b8": k1600["shape"],
            "ms_at_1600px_b8": k1600[kname]["ms"],
            "bound_ms_at_1600px_b8": k1600[kname]["bound_ms"],
            "max_abs_err_at_1600px_b8": k1600[kname]["max_abs_err"],
            "max_abs_err_bf16_features": b16["kernels_bf16_features"][
                kname]["max_abs_err"],
            "ms_bf16_features": b16["kernels_bf16_features"][kname]["ms"]})
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
