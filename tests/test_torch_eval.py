"""The port's evaluation modules against the JAX package's, on the same
seeded inputs: cross-scene aggregation and its report (equal strings),
the scene queue and its metrics.txt, point-cloud accuracy/completeness
(distances within 1e-5 of a float64 brute force, and JAX's within its
float32 bound), pose and intrinsics import
(quaternions within 1e-6), and one refinement iteration with every pose
fixed (the known-pose triangulation mode)."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from detectorfreesfm_tpu.eval import aggregate as JG  # noqa: E402
from detectorfreesfm_tpu.eval import pointcloud as JPC  # noqa: E402
from detectorfreesfm_tpu.parallel import orchestrate as JO  # noqa: E402
from detectorfreesfm_tpu.sfm import model_import as JMI  # noqa: E402
from detectorfreesfm_tpu_torch.eval import aggregate as TG  # noqa: E402
from detectorfreesfm_tpu_torch.eval import pointcloud as TPC  # noqa: E402
from detectorfreesfm_tpu_torch.parallel import orchestrate as TO  # noqa: E402
from detectorfreesfm_tpu_torch.sfm import model_import as TMI  # noqa: E402
from test_torch_refine import (  # noqa: E402,F401
    R4,
    _one_torch_thread,
    _same_model,
    _scene_images,
)


# --- eval/aggregate.py ------------------------------------------------------


def _per_scene(seed, names):
    rng = np.random.default_rng(seed)
    keys = ["auc@5", "auc@10", "registered_ratio", "wall_s"]
    return {n: {k: float(rng.uniform()) for k in keys[: 2 + i % 3]}
            for i, n in enumerate(names)}


@pytest.mark.parametrize("group_bags", [False, True])
def test_aggregate_and_report_equal_jax(group_bags):
    """Averages per key and per IMC bag (10bag after 3bag, a scene
    without a marker in [all] only), the unequal-counts warning, and the
    report: equal dicts and equal strings."""
    per_scene = _per_scene(0, ["b_10bag_x", "a_3bag", "c_3bag", "plain",
                               "d_25bag"])
    agg = TG.aggregate_multi_scene_metrics(per_scene, group_bags)
    assert agg == JG.aggregate_multi_scene_metrics(per_scene, group_bags)
    assert list(agg) == (["all", "3bag", "10bag", "25bag"] if group_bags
                         else ["all"])
    assert agg["all"]["_warning_unequal_counts"] == 1.0
    for ps in (per_scene, None):
        assert (TG.format_report(agg, ps, title="t")
                == JG.format_report(agg, ps, title="t"))


# --- parallel/orchestrate.py -----------------------------------------------


def test_chunkers_equal_jax():
    items = list("abcdefghij")
    for n in (1, 3, 4, 11):
        assert TO.chunks(items, n) == JO.chunks(items, n)
        assert TO.chunks_balance(items, n) == JO.chunks_balance(items, n)
        assert TO.chunk_index(10, n) == JO.chunk_index(10, n)
        assert TO.chunk_index_balance(10, n) == JO.chunk_index_balance(10, n)
    d = {k: i for i, k in enumerate("qwertyu")}
    assert TO.split_dict(d, 3) == JO.split_dict(d, 3)
    for pi in range(3):
        assert (TO.local_shard(items, pi, 3)
                == JO.local_shard(items, process_index=pi, process_count=3))
    # without a torch.distributed group: this process is 0 of 1
    assert TO.local_shard(items) == items
    assert TO.allgather_objects({"a": 1}) == [{"a": 1}]


def _scene_fn(s):
    if s == "boom_3bag":
        raise RuntimeError("scene crashed")
    i = int(s[1])
    return {"status": "ok", "n_registered": 3 + i % 2, "n_images": 4,
            "pose_auc": {"auc@5": 0.25 * i, "auc@10": 0.2 * i}}


def test_run_eval_scenes_equals_jax(tmp_path, capsys):
    """One process: a scene that raises is a failed scene (registered
    ratio 0), one JSON line per scene, and metrics.txt as the JAX
    package's run_eval_scenes (instant scenes: wall_s is 0.0 in both)."""
    import json

    scenes = ["s0_3bag", "boom_3bag", "s1_5bag", "s2_3bag"]
    got = TO.run_eval_scenes(scenes, _scene_fn, str(tmp_path / "t"),
                             imc_bags=True, title="d")
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"scene"')]
    ref = JO.run_eval_scenes(scenes, _scene_fn, str(tmp_path / "j"),
                             imc_bags=True, title="d")
    assert got == ref
    assert [ln["scene"] for ln in lines] == scenes
    assert lines[1]["status"] == "failed" and "scene crashed" in lines[1][
        "error"]
    assert got[0]["boom_3bag"]["registered_ratio"] == 0.0
    assert ((tmp_path / "t" / "metrics.txt").read_text()
            == (tmp_path / "j" / "metrics.txt").read_text())


def test_run_eval_scenes_takes_its_strided_share(tmp_path, capsys):
    """Process 1 of 2 reconstructs scenes 1 and 3 and writes no
    metrics.txt; process 0 of 2 scenes 0 and 2."""
    scenes = ["s0_3bag", "s1_3bag", "s2_3bag", "s3_3bag"]
    assert TO.run_eval_scenes(scenes, _scene_fn, str(tmp_path / "p1"),
                              process_index=1, process_count=2) == (None,
                                                                    None)
    assert not (tmp_path / "p1").exists()
    per_scene, _report = TO.run_eval_scenes(
        scenes, _scene_fn, str(tmp_path / "p0"), process_index=0,
        process_count=2)
    assert sorted(per_scene) == ["s0_3bag", "s2_3bag"]
    out = capsys.readouterr().out
    assert out.count('{"scene"') == 4


# --- eval/pointcloud.py -----------------------------------------------------


def _clouds(seed):
    """A ground-truth cloud at scene scale (coordinates up to ~10) and a
    reconstruction of part of it with noise and far-away junk."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-3, 3, (3000, 3)) + np.array([0.0, 0.0, 8.0])
    rec = np.concatenate([
        gt[:1500] + rng.normal(scale=0.03, size=(1500, 3)),
        rng.uniform(20, 21, (200, 3))])
    return rec, gt


def _exact_nn(q, r):
    """float64 brute force: (NN distance, squared norm of the NN)."""
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    i = d2.argmin(1)
    return np.sqrt(d2[np.arange(len(q)), i]), (r[i] ** 2).sum(-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_accuracy_completeness_equals_jax(seed):
    """Both packages against a float64 brute force on scene-scale clouds.
    The port's NN distances are within 1e-5 of it and its fractions equal
    its fractions. JAX's |q|^2 - 2 q.r + |r|^2 in float32 is off by up to
    ~1e-3 in distance near 0 (cancellation at |q|^2 ~ 100): its squared
    distances are within 4 eps (|q|^2 + |r|^2) of the exact ones, and its
    fractions equal the exact ones but for points within that bound of a
    tolerance. Block sizes that do not divide the cloud."""
    rec, gt = _clouds(seed)
    tols = (0.02, 0.05, 0.1)
    got = TPC.accuracy_completeness(rec, gt, tols, device="cpu")
    ref = JPC.accuracy_completeness(rec, gt, tols)
    assert 0.2 < got["accuracy@0.05"] < 0.9
    eps = np.finfo(np.float32).eps
    for name, q, r in (("accuracy", rec, gt), ("completeness", gt, rec)):
        exact, r2 = _exact_nn(q, r)
        d = TPC.nn_distances(q, r, block=1000, device="cpu")
        np.testing.assert_allclose(d, exact, rtol=0, atol=1e-5)
        bound = 4 * eps * ((q ** 2).sum(-1) + r2)
        dj = JPC.nn_distances(q, r).astype(np.float64)
        assert (np.abs(dj ** 2 - exact ** 2) <= bound).all()
        for t in tols:
            assert got[f"{name}@{t}"] == (exact <= t).mean()
            near = (np.abs(exact ** 2 - t * t) <= bound).sum()
            assert abs(ref[f"{name}@{t}"] - got[f"{name}@{t}"]) * len(
                q) <= near, (name, t, near)
    assert TPC.nn_distances(rec[:0], gt, device="cpu").shape == (0,)
    assert np.isinf(TPC.nn_distances(rec, gt[:0], device="cpu")).all()


def test_accuracy_completeness_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec, gt = _clouds(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPC.accuracy_completeness(rec, gt)


# --- sfm/model_import.py ----------------------------------------------------


def _pose_files(tmp_path, seed=0):
    from detectorfreesfm_tpu_torch.core.geometry import np_quat_to_rotmat

    rng = np.random.default_rng(seed)
    poses_dir, intrin_dir = tmp_path / "poses", tmp_path / "intrins"
    poses_dir.mkdir()
    intrin_dir.mkdir()
    for i in range(4):
        q = rng.normal(size=4)
        m = np.eye(4)
        m[:3, :3] = np_quat_to_rotmat(q / np.linalg.norm(q))
        m[:3, 3] = rng.normal(size=3)
        np.savetxt(poses_dir / f"im{i}.txt", m)
        K = np.array([[500.0 + i, 0, 320], [0, 510, 240], [0, 0, 1]])
        # a 3x3 K, and one file of four values
        np.savetxt(intrin_dir / f"im{i}.txt",
                   K if i else np.array([500.0, 510, 320, 240]))
    return str(poses_dir), str(intrin_dir)


@pytest.mark.parametrize("pose_format", ["w2c", "c2w"])
def test_load_pose_dir_and_empty_model_equal_jax(tmp_path, pose_format):
    """Both pose conventions (quaternions within 1e-6: both packages
    convert in float32), the intrinsics files, and the empty model built
    from them: the same cameras, the same registered images and poses, no
    points; an image without a pose file stays unregistered."""
    poses_dir, intrin_dir = _pose_files(tmp_path)
    got = TMI.load_pose_dir(poses_dir, pose_format)
    ref = JMI.load_pose_dir(poses_dir, pose_format)
    assert sorted(got) == sorted(ref) == ["im0", "im1", "im2", "im3"]
    for k in ref:
        np.testing.assert_allclose(got[k][0], ref[k][0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[k][1], ref[k][1])
    ki, kj = TMI.load_intrin_dir(intrin_dir), JMI.load_intrin_dir(intrin_dir)
    assert sorted(ki) == sorted(kj)
    for k in kj:
        np.testing.assert_array_equal(ki[k], kj[k])
    sizes = {f"im{i}.png": (640, 480) for i in range(5)}
    kpts = {"im1.png": np.arange(10.0).reshape(5, 2)}
    intr = {k: v for k, v in kj.items() if v.shape == (3, 3)}
    a = TMI.generate_empty_model(sizes, got, intr, kpts)
    b = JMI.generate_empty_model(sizes, ref, intr, kpts)
    assert sorted(a.registered_images) == sorted(b.registered_images) == [
        1, 2, 3, 4]
    assert not a.points and not b.points
    for i, im in b.images.items():
        assert a.images[i].name == im.name
        np.testing.assert_array_equal(a.images[i].xys, im.xys)
        np.testing.assert_array_equal(a.cameras[i].params,
                                      b.cameras[i].params)
        if im.qvec is not None:
            np.testing.assert_allclose(a.images[i].qvec, im.qvec, atol=1e-6)
            np.testing.assert_array_equal(a.images[i].tvec, im.tvec)
    if pose_format == "c2w":
        # the camera centre is the c2w matrix's translation
        from detectorfreesfm_tpu_torch.core.geometry import np_quat_to_rotmat

        m = np.loadtxt(os.path.join(poses_dir, "im2.txt"))
        q, t = got["im2"]
        np.testing.assert_allclose(-np_quat_to_rotmat(q).T @ t, m[:3, 3],
                                   atol=1e-5)


def test_import_from_colmap_prior_equals_jax(tmp_path):
    """A model with points written by the port, read back by both
    packages with its points stripped: the same cameras, images, poses
    and keypoints, and no observation left."""
    from detectorfreesfm_tpu_torch.data.colmap_io import Camera
    from detectorfreesfm_tpu_torch.sfm.reconstruction import (
        Reconstruction,
        RImage,
    )

    rng = np.random.default_rng(3)
    rec = Reconstruction()
    rec.add_camera(Camera(1, "PINHOLE", 64, 64,
                          np.array([50.0, 50, 32, 32])))
    for i in (1, 2, 3):
        rec.add_image(RImage(id=i, name=f"i{i}.png", camera_id=1,
                             xys=rng.uniform(0, 64, (5, 2))))
        q = rng.normal(size=4)
        rec.set_pose(i, q / np.linalg.norm(q), rng.normal(size=3))
    rec.add_point(np.array([0.0, 0, 3]), [(1, 0), (2, 1), (3, 4)])
    out = tmp_path / "model"
    out.mkdir()
    rec.write(str(out))
    a = TMI.import_from_colmap_prior(str(out))
    b = JMI.import_from_colmap_prior(str(out))
    assert len(a.points) == len(b.points) == 0
    assert sorted(a.registered_images) == sorted(b.registered_images) == [
        1, 2, 3]
    for i, im in b.images.items():
        assert (a.images[i].point3D_ids == -1).all()
        for f in ("xys", "qvec", "tvec"):
            np.testing.assert_array_equal(getattr(a.images[i], f),
                                          getattr(im, f))
    assert a.cameras[1].model == b.cameras[1].model == "PINHOLE"
    np.testing.assert_array_equal(a.cameras[1].params, b.cameras[1].params)


# --- refine/loop.py: fix_all_poses -------------------------------------------


def _small_model_both():
    """tests/test_refiner.py's small reconstruction (5 cameras, 200
    points), made by the port's mapper (which equals the JAX mapper's,
    test_torch_mapper.py) and copied into the JAX package's classes."""
    import copy

    from detectorfreesfm_tpu.data import colmap_io as jcio
    from detectorfreesfm_tpu.sfm import mapper as jmapper
    from detectorfreesfm_tpu.sfm import reconstruction as jr
    from detectorfreesfm_tpu.sfm.tracks import Track
    from detectorfreesfm_tpu_torch.sfm.mapper import (
        IncrementalMapper,
        MapperConfig,
    )
    from test_mapper import _multi_view_scene, _scene_to_matches

    _pts, K, _poses, uvs, visible = _multi_view_scene(5, n_pts=200, seed=21)
    keypoints, matches = _scene_to_matches(5, uvs, visible)
    m = IncrementalMapper(MapperConfig(abs_pose_min_num_inliers=15),
                          device="cpu")
    rec = m.run(keypoints, matches, {n: (640, 480) for n in keypoints},
                {n: K for n in keypoints})
    jrec = jr.Reconstruction()
    for c in rec.cameras.values():
        jrec.add_camera(jcio.Camera(c.id, c.model, c.width, c.height,
                                    c.params.copy()))
    for im in rec.images.values():
        jrec.add_image(jr.RImage(
            id=im.id, name=im.name, camera_id=im.camera_id,
            xys=im.xys.copy(), qvec=im.qvec.copy(), tvec=im.tvec.copy(),
            point3D_ids=im.point3D_ids.copy()))
    jrec.points = copy.deepcopy(rec.points)
    jrec._next_pid = rec._next_pid
    jm = jmapper.IncrementalMapper(jmapper.MapperConfig(**vars(m.cfg)))
    jm.names, jm.name_to_id = list(m.names), dict(m.name_to_id)
    jm.unknown_K = set(m.unknown_K)
    jm.tracks = [Track(list(t.observations)) for t in m.tracks]
    jm.track_pid = m.track_pid.copy()
    jm.kpt_track = copy.deepcopy(m.kpt_track)
    return (jrec, jm), (rec, m)


def _moved(xy, lib):
    """The stand-in refiner of test_refinement_with_fixed_poses_equals_jax:
    every node moves by up to 2 px, by the same float32 function in both
    packages."""
    return xy + 2.0 * lib.sin(0.37 * xy + 0.5)


def test_refinement_with_fixed_poses_equals_jax(monkeypatch):
    """One iteration with fix_all_poses=True on test_torch_refine.py's
    model and helpers, with one image dropped first. The refiner network
    (held to JAX's by test_torch_refine.py) is replaced in both packages by
    the same deterministic move of every keypoint, so that the geometry
    step that fix_all_poses changes runs on equal inputs without JAX
    compiling the network. Every registered pose comes out as it went in
    (within 1e-5: BA's float32 round trip), the dropped image is not
    re-registered, and the keypoints (atol 1e-3 px), the filter's counts
    and the points (1e-3 scene units) equal JAX's."""
    import collections

    import jax.numpy as jnp

    from detectorfreesfm_tpu.refine import loop as JL
    from detectorfreesfm_tpu_torch.refine import loop as TL

    Out = collections.namedtuple("Out", "coords")

    class JaxStandIn:
        def __init__(self, cfg):
            pass

        def apply(self, params, images, node_img, node_xy, scale, mask):
            return Out(_moved(node_xy, jnp))

    monkeypatch.setattr(JL, "MultiviewRefiner", JaxStandIn)
    monkeypatch.setattr(TL, "_build_refiner", lambda *a: (
        lambda images, node_img, node_xy, scale, mask: Out(
            _moved(node_xy, torch))))

    (jrec, jm), (rec, m) = _small_model_both()
    dropped = jrec.registered_images[-1]
    rec.deregister(dropped)
    jrec.deregister(dropped)
    before = {i: (rec.images[i].qvec.copy(), rec.images[i].tvec.copy())
              for i in rec.registered_images}
    n_before = len(rec.points)
    images = _scene_images(jrec)
    kw = dict(n_iters=1, windows=(7,), chunk_tracks=64, max_track_length=8,
              filter_thresholds=(3.0,), fix_all_poses=True)
    info = {}
    TL.refine_reconstruction(rec, images, {}, TL.RefineConfig(**kw),
                             mapper=m, device="cpu", info=info)
    JL.refine_reconstruction(jrec, images, {}, JL.RefineConfig(**kw),
                             mapper=jm)
    assert info["iterations_completed"] == 1 and info["error"] is None
    it = info["iterations"][0]
    assert it["reregistered"] == [] and it["median_shift_px"] > 0.5
    assert 0 < it["filtered"] < n_before
    assert sorted(rec.registered_images) == sorted(before)
    assert sorted(jrec.registered_images) == sorted(before)
    for i, (q, t) in before.items():
        np.testing.assert_allclose(rec.images[i].qvec, q, rtol=0, atol=1e-5)
        np.testing.assert_allclose(rec.images[i].tvec, t, rtol=0, atol=1e-5)
    for i, im in jrec.images.items():
        np.testing.assert_allclose(rec.images[i].xys, im.xys, atol=1e-3)
    _same_model(rec, jrec, atol=1e-3)
