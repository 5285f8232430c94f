"""The port's pair-matching engine against the JAX engine, and the port's
import and device contracts.

Run as a script, this file records the reference numbers that the GPU smoke
test (chip_smoke.py) holds the port to: the dense fp32 JAX engine on the
CPU, on generate_scene(seed=0, size=832, n_views=4), coarse_fine with
matches rounded to a 4 px grid:

    JAX_PLATFORMS=cpu python tests/test_torch_engine.py [--size 832]

and, with `--dtype bfloat16`, the same engine with its matcher in bf16
(the numbers of the smoke's `bf16` phase).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "demo_matcher_r5_bf16.msgpack")


def _scene(size, n_views, seed=0):
    from detectorfreesfm_tpu_torch.data.synthetic import (
        SyntheticConfig,
        generate_scene,
    )

    return generate_scene(seed, SyntheticConfig(size=size, n_views=n_views))


def _epipolar_summary(raw, names, K, q, t):
    """Per-pair valid counts and the pooled median symmetric epipolar
    error (px) of the matches against the scene's ground truth."""
    from detectorfreesfm_tpu_torch.data.synthetic import (
        fundamental_matrix,
        symmetric_epipolar_error,
    )

    counts, errs = {}, []
    for (a, b), m in raw.items():
        i, j = names.index(a), names.index(b)
        F = fundamental_matrix(K[i], q[i], t[i], K[j], q[j], t[j])
        counts[f"{a}-{b}"] = int(len(m["conf"]))
        if len(m["conf"]):
            errs.append(symmetric_epipolar_error(F, m["kpts0"], m["kpts1"]))
    e = np.concatenate(errs) if errs else np.array([np.inf])
    return counts, float(np.median(e))


def _jax_engine_matches(images, names, pairs, size, dtype="float32"):
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from detectorfreesfm_tpu.data.images import LoadedImage as JaxImage
    from detectorfreesfm_tpu.match.engine import (
        EngineConfig as JaxEngineConfig,
        PairMatchingEngine as JaxEngine,
    )
    from detectorfreesfm_tpu.parallel.mesh import make_mesh

    # The checkpoint's tree cast to fp32, as load_matcher_params casts it to
    # its fp32 template, without that loader's template init.
    with open(WEIGHTS, "rb") as f:
        raw = serialization.msgpack_restore(f.read())["params"]
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                    raw)
    cfg = JaxEngineConfig(img_resize=size, fine_enabled=True,
                          round_matches_ratio=4, batch_size=1,
                          compute_dtype=dtype)
    engine = JaxEngine(cfg, params=params,
                       mesh=make_mesh(1, devices=jax.devices()[:1]))
    imgs = {n: JaxImage(images[i], np.ones(2, np.float32), (size, size),
                        (size, size)) for i, n in enumerate(names)}
    return engine.match_pairs(pairs, imgs)


def _port_engine(size, fused, batch_size=2):
    from detectorfreesfm_tpu_torch.match.engine import (
        EngineConfig,
        PairMatchingEngine,
    )
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params

    cfg = EngineConfig(img_resize=size, fine_enabled=True,
                       round_matches_ratio=4, fused_matching=fused,
                       batch_size=batch_size)
    params = load_matcher_params(WEIGHTS, cfg.matcher_config())
    return PairMatchingEngine(cfg, params, device="cpu")


def _port_images(images, names):
    from detectorfreesfm_tpu_torch.data.images import from_array

    return {n: from_array(images[i]) for i, n in enumerate(names)}


def _rows(m):
    return {tuple(r) for r in np.concatenate([m["kpts0"], m["kpts1"]],
                                             1).tolist()}


def _iou(a, b):
    return len(a & b) / max(len(a | b), 1)


@pytest.fixture(scope="module")
def engine_outputs():
    """3 views at 256 px through the JAX engine (dense) and the port's
    engine, dense and fused (the kernels' plain versions on the CPU);
    coarse_fine, 4 px rounding, batches of 2 so the last one is padded."""
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs

    size = 256
    images, _d, K, q, t = _scene(size, 3, seed=1)
    names = [f"view_{i}" for i in range(3)]
    pairs = exhaustive_pairs(names)
    imgs = _port_images(images, names)
    return dict(
        pairs=pairs,
        jax=_jax_engine_matches(images, names, pairs, size),
        dense=_port_engine(size, fused=False).match_pairs(pairs, imgs),
        fused=_port_engine(size, fused=True).match_pairs(pairs, imgs))


def test_engine_matches_equal_jax_engine(engine_outputs):
    """The same rounded matches pair for pair. Rounding to the 4 px grid
    absorbs the fp32 summation-order differences of the fine offsets, so
    the match sets are held to IoU >= 0.95, not to bit equality."""
    pairs, jax_raw, port_raw = (engine_outputs[k]
                                for k in ("pairs", "jax", "dense"))
    assert set(port_raw) == set(pairs)
    for p in pairs:
        a, b = _rows(jax_raw[p]), _rows(port_raw[p])
        assert len(a) > 20, (p, len(a))
        assert _iou(a, b) >= 0.95, (p, len(a), len(b))


def test_merged_keypoints_equal_jax_engine(engine_outputs):
    """After merge_matches_to_keypoints: the same keypoint sets per image
    and the same index matches (as coordinate pairs), IoU >= 0.95."""
    from detectorfreesfm_tpu.ops.grid_merge import (
        merge_matches_to_keypoints as jax_merge,
    )
    from detectorfreesfm_tpu_torch.ops.grid_merge import (
        merge_matches_to_keypoints,
    )

    jk, _js, jm = jax_merge(engine_outputs["jax"])
    pk, _ps, pm = merge_matches_to_keypoints(engine_outputs["dense"])
    assert set(jk) == set(pk)
    for name in jk:
        a = {tuple(r) for r in jk[name].tolist()}
        b = {tuple(r) for r in pk[name].tolist()}
        assert _iou(a, b) >= 0.95, name
    for (n0, n1), idx in jm.items():
        a = {tuple(jk[n0][i].tolist() + jk[n1][j].tolist()) for i, j in idx}
        b = {tuple(pk[n0][i].tolist() + pk[n1][j].tolist())
             for i, j in pm[(n0, n1)]}
        assert _iou(a, b) >= 0.95, (n0, n1)


def test_fused_engine_matches_dense_engine(engine_outputs):
    """fused_matching=True gives the dense path's matches, pair for pair."""
    dense, fused = engine_outputs["dense"], engine_outputs["fused"]
    assert set(fused) == set(engine_outputs["pairs"])
    for p in engine_outputs["pairs"]:
        assert len(_rows(dense[p])) > 20
        assert _iou(_rows(dense[p]), _rows(fused[p])) >= 0.95, p


_IMPORT_PROBE = r"""
import sys, numpy as np, torch
torch.set_num_threads(1)  # beside the suite's other workers
sys.path.insert(0, {repo!r})
from detectorfreesfm_tpu_torch.match import engine
from detectorfreesfm_tpu_torch.data.images import from_array
from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params
cfg = engine.EngineConfig(img_resize=64, fine_enabled=True,
                          fused_matching=True)
params = load_matcher_params({weights!r}, cfg.matcher_config())
eng = engine.PairMatchingEngine(cfg, params, device="cpu")
rng = np.random.default_rng(0)
img = from_array(rng.uniform(size=(64, 64)).astype(np.float32))
out = eng.match_pairs([("a", "b")], {{"a": img, "b": img}})
assert len(out[("a", "b")]["conf"]) > 0
# The geometry slice, end to end at a tiny size.
import os, tempfile
from detectorfreesfm_tpu_torch.core import epipolar, geometry, precision
from detectorfreesfm_tpu_torch.core.triangulation import triangulate_dlt
from detectorfreesfm_tpu_torch.data import colmap_io, database, h5io
from detectorfreesfm_tpu_torch.sfm import (ba, model_select, pnp,
                                           reconstruction, tracks, twoview)
from detectorfreesfm_tpu_torch.utils import prng
x = rng.normal(size=(1, 64, 2)).astype(np.float32) * 0.1
m = np.ones((1, 64), bool)
keys = prng.stable_rngs([("verify", "a", "b", 0)])
g = prng.gumbel(keys, (16, 64), device="cpu")
twoview.estimate_relative_pose_batch(x, x + 0.01, m, g, [1e-3], device="cpu")
twoview.estimate_homography_batch(x, x + 0.01, m, g, [1e-3], device="cpu")
X = np.concatenate([x, np.full((1, 64, 1), 5.0, np.float32)], -1)
pnp.estimate_absolute_pose_batch(X, x, m, g, [1e-3], device="cpu")
P = np.tile(np.eye(3, 4, dtype=np.float32), (8, 2, 1, 1))
P[:, 1, 0, 3] = 1.0
triangulate_dlt(P, np.zeros((8, 2, 2), np.float32), device="cpu")
q = np.array([[1.0, 0, 0, 0], [1.0, 0, 0, 0]])
t = np.array([[0.0, 0, 0], [1.0, 0, 0]])
pts = rng.normal(size=(20, 3)) + [0, 0, 5]
uv = np.concatenate([pts[:, :2] / pts[:, 2:], (pts[:, :2] + [1, 0])
                     / pts[:, 2:]]) * 500 + 320
ba.bundle_adjust(q, t, np.tile([500.0, 500, 320, 320], (2, 1)), pts, uv,
                 np.repeat([0, 1], 20), np.tile(np.arange(20), 2),
                 max_iters=2, device="cpu")
tracks.build_tracks({{1: 5, 2: 5}}, {{(1, 2): np.array([[0, 1], [2, 3]])}})
with tempfile.TemporaryDirectory() as d:
    h5io.load_h5(h5io.save_h5({{"k": x}}, os.path.join(d, "s.h5"), False)[:-4],
                 False)
    rec = reconstruction.Reconstruction()
    rec.add_camera(colmap_io.Camera(1, "PINHOLE", 9, 9, np.ones(4)))
    rec.write(os.path.join(d, "m"))
    colmap_io.read_model(os.path.join(d, "m"))
    model_select.best_model([rec])
    database.export_scene_to_database(os.path.join(d, "x.db"), {{}}, {{}},
                                      {{}})
# The mapper and refinement slice, end to end at a tiny size; scipy only
# once merge_tracks runs.
from detectorfreesfm_tpu_torch.models import multiview_matcher, s2dnet
from detectorfreesfm_tpu_torch.ops import roi_align
from detectorfreesfm_tpu_torch.refine import bags, loop
from detectorfreesfm_tpu_torch.sfm import mapper
from detectorfreesfm_tpu_torch.utils.checkpoint import load_refiner_params
assert "scipy" not in sys.modules, "scipy imported at module level"
pts = rng.uniform(-1, 1, (120, 3)) + [0, 0, 6]
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
kps = {{}}
for i in range(4):
    a = (i - 1.5) * 0.3
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    Xc = (pts - [6 * np.sin(a), 0, 6 - 6 * np.cos(a)]) @ R.T
    kps[f"im{{i}}"] = ((Xc / Xc[:, 2:]) @ K.T)[:, :2]
ids = np.stack([np.arange(120)] * 2, 1).astype(np.int32)
mp = mapper.IncrementalMapper(mapper.MapperConfig(
    abs_pose_min_num_inliers=15), device="cpu")
rec = mp.run(kps, {{(a, b): ids for a in kps for b in kps if a < b}},
             {{n: (320, 240) for n in kps}}, {{n: K for n in kps}})
assert len(rec.registered_images) == 4, rec.registered_images
info = {{}}
loop.refine_reconstruction(
    rec, {{i: rng.uniform(size=(240, 320)).astype(np.float32)
          for i in rec.images}},
    load_refiner_params(os.path.join(os.path.dirname({weights!r}),
                                     "demo_refiner_r4_bf16.msgpack"),
                        device="cpu"),
    loop.RefineConfig(n_iters=1, windows=(7,), chunk_tracks=64,
                      max_track_length=4),
    mapper=mp, device="cpu", info=info)
assert info["iterations_completed"] == 1, info
# The scene pipeline and the reconstruct verb on a tiny PNG scene from
# cached matches, as on the GPU machine: no h5py (the stores fall back to
# npz), no PIL, and the native image loader disabled (PNG through numpy).
sys.modules["h5py"] = sys.modules["PIL"] = None  # imports of them fail
from detectorfreesfm_tpu_torch import cli, pipeline
from detectorfreesfm_tpu_torch.data import images, png
images._native_error = "disabled for this probe"
d = tempfile.mkdtemp()
for out in ("out", "out_cli"):
    scene = os.path.join(d, "scene")
    os.makedirs(os.path.join(scene, "images"), exist_ok=True)
    for n in kps:
        png.write_png(os.path.join(scene, "images", n + ".png"),
                      (rng.uniform(size=(240, 320)) * 255).astype(np.uint8))
    os.makedirs(os.path.join(d, out), exist_ok=True)
    h5io.save_h5({{n + ".png": k for n, k in kps.items()}},
                 os.path.join(d, out, "keypoints.h5"))
    h5io.save_h5({{f"{{a}}.png|{{b}}.png": ids for a in kps for b in kps
                  if a < b}}, os.path.join(d, out, "matches.h5"))
rec = pipeline.reconstruct_scene(
    os.path.join(scene, "images"), os.path.join(d, "out"),
    pipeline.PipelineConfig(
        img_resize=320, n_refine_iters=1,
        mapper=mapper.MapperConfig(abs_pose_min_num_inliers=15),
        refine=loop.RefineConfig(windows=(7,), chunk_tracks=64,
                                 max_track_length=4)),
    intrinsics={{n + ".png": K for n in kps}},
    refiner_params=load_refiner_params(
        os.path.join(os.path.dirname({weights!r}),
                     "demo_refiner_r4_bf16.msgpack"), device="cpu"),
    device="cpu")
assert len(rec.registered_images) == 4 and images.last_backend == "png"
assert os.path.exists(os.path.join(d, "out", "keypoints.h5.npz"))
assert cli.main(["reconstruct", "--images", os.path.join(scene, "images"),
                 "--output", os.path.join(d, "out_cli"), "--device", "cpu",
                 "--refine-iters", "0", "--min-inliers", "15"]) == 0
from detectorfreesfm_tpu_torch.eval import aggregate, pointcloud
from detectorfreesfm_tpu_torch.parallel import orchestrate
from detectorfreesfm_tpu_torch.sfm import model_import
assert pointcloud.accuracy_completeness(
    np.zeros((3, 3)), np.ones((4, 3)), device="cpu")["accuracy@0.01"] == 0.0
assert orchestrate.allgather_objects({{"a": 1}}) == [{{"a": 1}}]
import shutil
shutil.rmtree(d)
banned = ("jax", "jaxlib", "flax", "msgpack", "h5py", "PIL",
          "detectorfreesfm_tpu")
bad = sorted(m for m, mod in sys.modules.items()
             if mod is not None and m.split(".")[0] in banned)
print("FORBIDDEN", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_or_missing_packages():
    """In a fresh interpreter (conftest imports jax into this one), the
    port's forward on the CPU, every geometry, store and estimator module,
    the mapper and one refinement iteration, the scene pipeline and the
    reconstruct verb (on PNG files, with h5py and PIL blocked and the
    native image loader off), and the evaluation modules, run once at a
    tiny size, pull in none of
    jax, flax, msgpack, h5py, PIL or the JAX package, and scipy only where
    merge_tracks needs it."""
    code = _IMPORT_PROBE.format(repo=REPO, weights=WEIGHTS)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_needs_cuda(monkeypatch):
    """device=None means CUDA; without it the entry point raises instead
    of falling back to the CPU."""
    import torch

    from detectorfreesfm_tpu_torch.device import resolve_device
    from detectorfreesfm_tpu_torch.match.engine import (
        EngineConfig,
        PairMatchingEngine,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PairMatchingEngine(EngineConfig(img_resize=64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_scene_generator_equals_jax_copy():
    """The port's numpy copy of generate_scene renders the JAX package's
    scene bit for bit."""
    from detectorfreesfm_tpu.data.synthetic import (
        SyntheticConfig as JaxSC,
        generate_scene as jax_generate_scene,
    )

    ours = _scene(96, 3, seed=4)
    ref = jax_generate_scene(4, JaxSC(size=96, n_views=3))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_epipolar_error_is_zero_on_true_correspondences():
    """Points projected from the scene's own geometry have ~0 error, and a
    shifted point has the error its offset implies."""
    from detectorfreesfm_tpu_torch.data.synthetic import (
        fundamental_matrix,
        quat_to_rotmat,
        symmetric_epipolar_error,
    )

    _img, _d, K, q, t = _scene(64, 2, seed=3)
    X = np.random.default_rng(0).uniform(-1, 1, (50, 3)) + [0, 0, 6.0]
    proj = []
    for v in range(2):
        xc = X @ quat_to_rotmat(q[v]).T + t[v]
        xh = xc @ K[v].T
        proj.append(xh[:, :2] / xh[:, 2:])
    F = fundamental_matrix(K[0], q[0], t[0], K[1], q[1], t[1])
    assert symmetric_epipolar_error(F, proj[0], proj[1]).max() < 1e-6
    assert symmetric_epipolar_error(F, proj[0], proj[1] + 3.0).mean() > 0.5


def record_jax_reference(size=832, n_views=4, seed=0, dtype="float32"):
    """Print the dense JAX engine's numbers on the smoke's scene."""
    import json
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs

    images, _d, K, q, t = _scene(size, n_views, seed)
    names = [f"view_{i}" for i in range(n_views)]
    pairs = exhaustive_pairs(names)
    t0 = time.time()
    raw = _jax_engine_matches(images, names, pairs, size, dtype)
    counts, med = _epipolar_summary(raw, names, K, q, t)
    print(json.dumps({
        "engine": f"jax dense {dtype} cpu", "size": size, "n_views": n_views,
        "seed": seed, "valid_per_pair": counts,
        "total_valid": sum(counts.values()), "median_epipolar_px": med,
        "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    import argparse

    sys.path.insert(0, REPO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=832)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args()
    record_jax_reference(args.size, args.views, dtype=args.dtype)
