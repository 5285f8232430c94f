"""The port's refinement slice against the JAX package's, on the same
seeded inputs: patch gathers, S2DNet, the multiview refiner with the
bundled weights and their loader, track packing, the mapper's pair
verification and geometry refinement steps, and one refinement iteration
as a whole."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from detectorfreesfm_tpu_torch.utils.checkpoint import (  # noqa: E402
    flax_variables_to_state_dict,
    load_refiner_params,
)

WEIGHTS = os.path.join(REPO, "weights")
R4 = os.path.join(WEIGHTS, "demo_refiner_r4_bf16.msgpack")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's tests: the suite runs them beside
    other test workers on the same cores, where a pool of torch threads per
    worker slowed them ten- to twentyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --- ops/roi_align ----------------------------------------------------------


def _features(seed=0, b=2, h=20, w=24, c=3):
    return np.random.default_rng(seed).normal(size=(b, h, w, c)).astype(
        np.float32)


def test_extract_patches_equals_jax():
    """Points inside, on and outside the border, scales != 1: atol 1e-5."""
    from detectorfreesfm_tpu.ops.roi_align import extract_patches as jx
    from detectorfreesfm_tpu_torch.ops.roi_align import extract_patches

    feats = _features()
    rng = np.random.default_rng(1)
    centers = np.concatenate([
        rng.uniform(0, [24, 20], (12, 2)),
        [[0.0, 0.0], [23.0, 19.0], [-3.2, 5.5], [26.7, 21.4], [11.5, -4.0],
         [23.9, 10.25]]]).astype(np.float32)
    idx = rng.integers(0, 2, len(centers)).astype(np.int32)
    scales = rng.uniform(0.5, 2.0, len(centers)).astype(np.float32)
    for size, sc in ((19, scales), (7, None)):
        ref = np.asarray(jx(jnp.asarray(feats), jnp.asarray(centers),
                            jnp.asarray(idx), size,
                            None if sc is None else jnp.asarray(sc)))
        got = extract_patches(_t(feats), _t(centers), _t(idx), size,
                              None if sc is None else _t(sc)).numpy()
        assert got.shape == ref.shape == (len(centers), size, size, 3)
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_crop_and_resize_equals_jax():
    from detectorfreesfm_tpu.ops.roi_align import crop_and_resize as jx
    from detectorfreesfm_tpu_torch.ops.roi_align import crop_and_resize

    feats = _features(2)
    boxes = np.array([[1.5, 2.0, 9.25, 12.0], [-2.0, -1.0, 30.0, 25.0],
                      [10.0, 3.0, 10.5, 3.5]], np.float32)
    idx = np.array([0, 1, 1], np.int32)
    ref = np.asarray(jx(jnp.asarray(feats), jnp.asarray(boxes),
                        jnp.asarray(idx), (5, 7)))
    got = crop_and_resize(_t(feats), _t(boxes), _t(idx), (5, 7)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


# --- models/s2dnet -------------------------------------------------------------


@pytest.mark.parametrize("size", [19, 15, 11, 10])
def test_same_max_pool_equals_flax(size):
    from flax import linen as nn

    from detectorfreesfm_tpu_torch.models.s2dnet import _same_max_pool

    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(
        np.float32)
    ref = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                 padding="SAME"))
    got = _same_max_pool(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("src,dst", [(5, 19), (4, 15), (3, 11)])
def test_bilinear_upsample_equals_jax_image_resize(src, dst):
    import torch.nn.functional as F

    x = np.random.default_rng(src).normal(size=(2, src, src, 4)).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 4),
                                      method="bilinear"))
    got = F.interpolate(_t(x).permute(0, 3, 1, 2), size=(dst, dst),
                        mode="bilinear", align_corners=False,
                        antialias=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("crop", [19, 15, 11])
def test_s2dnet_equals_jax(crop):
    """Seeded flax parameters converted by the checkpoint converter:
    atol 1e-4 on the (N, P, P, 128) features."""
    from detectorfreesfm_tpu.models.s2dnet import S2DNet as JaxS2DNet
    from detectorfreesfm_tpu_torch.models.s2dnet import S2DNet

    x = np.random.default_rng(crop).uniform(size=(6, crop, crop, 1)).astype(
        np.float32)
    model = JaxS2DNet()
    variables = model.init(jax.random.PRNGKey(crop), jnp.asarray(x))
    ref = np.asarray(model.apply(variables, jnp.asarray(x)))
    net = S2DNet()
    net.load_state_dict(flax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(lambda a: _t(np.array(a)),
                                          variables["params"])}))
    with torch.no_grad():
        got = net(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (6, crop, crop, 128)
    np.testing.assert_allclose(got, ref, atol=1e-4)


# --- models/multiview_matcher and its weights ----------------------------------


def _refiner_inputs(seed=0, I=3, T=8, V=4, size=64):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (I, size, size, 1)).astype(np.float32)
    node_img = rng.integers(0, I, (T, V)).astype(np.int32)
    node_xy = rng.uniform(4, size - 4, (T, V, 2)).astype(np.float32)
    node_scale = rng.uniform(0.7, 1.4, (T, V)).astype(np.float32)
    node_scale[:, 0] = 1.0
    mask = np.ones((T, V), bool)
    mask[:, V - 1] = False
    mask[T - 2:] = False
    return images, node_img, node_xy, node_scale, mask


@pytest.mark.parametrize("radius", [0, 1])
def test_multiview_refiner_r4_equals_jax(radius):
    """The r4 weights through both converters; coords atol 1e-3 px, std
    atol 1e-4, at the first iteration's crop 19 / window 15."""
    from detectorfreesfm_tpu.models.multiview_matcher import (
        MultiviewRefiner as JaxRefiner,
    )
    from detectorfreesfm_tpu.models.multiview_matcher import (
        RefinerConfig as JaxRefinerConfig,
    )
    from detectorfreesfm_tpu.train.refiner_selfsup import (
        load_refiner_params as jax_load,
    )
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        MultiviewRefiner,
        RefinerConfig,
    )

    inputs = _refiner_inputs(radius)
    ref = JaxRefiner(JaxRefinerConfig(ref_move_radius=radius)).apply(
        jax_load(R4), *(jnp.asarray(a) for a in inputs))
    model = MultiviewRefiner(RefinerConfig(ref_move_radius=radius))
    model.load_state_dict(load_refiner_params(R4, device="cpu"))
    with torch.no_grad():
        got = model(*(_t(a) for a in inputs))
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords),
                               atol=1e-3)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(ref.std),
                               atol=1e-4)
    moved = np.abs(got.coords.numpy() - inputs[2])[inputs[4]]
    assert moved.max() > 0.01  # the weights do move the query points


@pytest.mark.parametrize("name", ["demo_refiner_r4_bf16.msgpack",
                                  "demo_refiner_r2_bf16.msgpack",
                                  "demo_refiner_bf16.msgpack"])
def test_load_refiner_params_bundled(name):
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        MultiviewRefiner,
    )

    state = load_refiner_params(os.path.join(WEIGHTS, name), device="cpu")
    assert set(state) == set(MultiviewRefiner().state_dict())
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in state.values())


def test_load_refiner_params_is_strict(tmp_path, monkeypatch):
    """A tree with a missing or an extra leaf raises; no device means CUDA."""
    from detectorfreesfm_tpu_torch.utils import checkpoint as ck

    tree = ck.read_variables(R4)
    missing = copy.deepcopy(tree)
    del missing["params"]["backbone"]["conv3_3"]["bias"]
    extra = copy.deepcopy(tree)
    extra["params"]["backbone"]["conv9"] = {
        "bias": torch.zeros(128, dtype=torch.bfloat16)}
    for bad, what in ((missing, "missing"), (extra, "unused")):
        monkeypatch.setattr(ck, "read_variables", lambda path, t=bad: t)
        with pytest.raises(ValueError, match=f"1 {what}"):
            ck.load_refiner_params(R4, device="cpu")
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_refiner_params(R4)


# --- the mapper: pair verification, and the geometry refinement steps --------


def test_verify_pairs_equals_jax():
    """demo_cached with focal search, pair by pair: the same kept pairs,
    inlier counts within 1% (rounded up to a whole inlier), the same
    homography ratios within that count tolerance, and the same voted
    focals (rtol 1e-9)."""
    import chip_smoke
    from test_torch_mapper import _demo

    from detectorfreesfm_tpu.sfm.mapper import IncrementalMapper as JaxMapper
    from detectorfreesfm_tpu.sfm.mapper import MapperConfig as JaxConfig
    from detectorfreesfm_tpu_torch.sfm.mapper import (
        IncrementalMapper,
        MapperConfig,
    )

    kps, matches = _demo()
    sizes = {n: chip_smoke.DEMO_SIZES[n] for n in kps}
    kw = chip_smoke.demo_mapper_kwargs(kps, 416)
    out = []
    for mapper in (IncrementalMapper(MapperConfig(**kw), device="cpu"),
                   JaxMapper(JaxConfig(**kw))):
        rec = mapper._setup(kps, sizes, None)
        ver = mapper.verify_pairs(rec, matches, focal_search=True)
        out.append((ver, {c: cam.params.copy()
                          for c, cam in rec.cameras.items()}))
    (port, port_cams), (ref, ref_cams) = out
    assert sorted(port) == sorted(ref) and len(ref) > 20
    for k, r in ref.items():
        p = port[k]
        tol = int(np.ceil(0.01 * r["n_inliers"]))
        assert abs(p["n_inliers"] - r["n_inliers"]) <= tol, k
        assert abs(p["h_ratio"] - r["h_ratio"]) * r["n_inliers"] <= tol, k
    for c, params in ref_cams.items():
        np.testing.assert_allclose(port_cams[c], params, rtol=1e-9)


def _to_port(jrec, jmapper):
    """The JAX mapper's model and track state as the port's."""
    from detectorfreesfm_tpu_torch.data import colmap_io
    from detectorfreesfm_tpu_torch.sfm.mapper import (
        IncrementalMapper,
        MapperConfig,
    )
    from detectorfreesfm_tpu_torch.sfm.reconstruction import (
        Reconstruction,
        RImage,
    )
    from detectorfreesfm_tpu_torch.sfm.tracks import Track

    rec = Reconstruction()
    for c in jrec.cameras.values():
        rec.add_camera(colmap_io.Camera(c.id, c.model, c.width, c.height,
                                        c.params.copy()))
    for im in jrec.images.values():
        rec.add_image(RImage(
            id=im.id, name=im.name, camera_id=im.camera_id,
            xys=im.xys.copy(),
            qvec=None if im.qvec is None else im.qvec.copy(),
            tvec=None if im.tvec is None else im.tvec.copy(),
            point3D_ids=im.point3D_ids.copy()))
    rec.points = copy.deepcopy(jrec.points)
    rec._next_pid = jrec._next_pid
    m = IncrementalMapper(MapperConfig(**vars(jmapper.cfg)), device="cpu")
    m.names, m.name_to_id = list(jmapper.names), dict(jmapper.name_to_id)
    m.unknown_K = set(jmapper.unknown_K)
    m.tracks = [Track(list(t.observations)) for t in jmapper.tracks]
    m.track_pid = jmapper.track_pid.copy()
    m.kpt_track = copy.deepcopy(jmapper.kpt_track)
    return rec, m


@pytest.fixture(scope="module")
def small_model():
    """tests/test_refiner.py's small reconstruction, made once by the JAX
    mapper; each test copies it for both packages."""
    from test_refiner import _small_reconstruction

    return _small_reconstruction()


def _pair(small_model):
    jrec, jm = copy.deepcopy(small_model)
    rec, m = _to_port(jrec, jm)
    return (jrec, jm), (rec, m)


def _same_model(rec, jrec, atol=1e-6):
    assert sorted(rec.points) == sorted(jrec.points)
    for p, pt in jrec.points.items():
        assert sorted(rec.points[p]["track"]) == sorted(pt["track"]), p
        np.testing.assert_allclose(rec.points[p]["xyz"], pt["xyz"],
                                   atol=atol)
    for i, im in jrec.images.items():
        np.testing.assert_array_equal(rec.images[i].point3D_ids,
                                      im.point3D_ids)


def _split_a_track(rec):
    """tests/test_refiner.py's split: half of the longest track becomes a
    second point 1e-4 away."""
    pid = max(rec.points, key=lambda p: (len(rec.points[p]["track"]), -p))
    track = list(rec.points[pid]["track"])
    moved = track[len(track) // 2:]
    for img_id, kpt in moved:
        rec.points[pid]["track"] = [o for o in rec.points[pid]["track"]
                                    if o != (img_id, kpt)]
        rec.images[img_id].point3D_ids[kpt] = -1
    return rec.add_point(rec.points[pid]["xyz"] + 1e-4, moved)


def test_merge_tracks_equals_jax(small_model):
    """A split track is merged back, and a tight threshold merges nothing,
    in both packages: the same counts and the same model."""
    (jrec, jm), (rec, m) = _pair(small_model)
    assert _split_a_track(rec) == _split_a_track(jrec) > 0
    n = m.merge_tracks(rec, 4.0)
    assert n == jm.merge_tracks(jrec, 4.0) >= 1
    _same_model(rec, jrec)
    np.testing.assert_array_equal(m.track_pid, jm.track_pid)
    assert m.merge_tracks(rec, 0.05) == jm.merge_tracks(jrec, 0.05) == 0


def test_complete_filter_retriangulate_equal_jax(small_model):
    """Filter at a tight threshold, complete the tracks again, and
    retriangulate: the same counts and the same model (points atol
    1e-6 in scene units)."""
    (jrec, jm), (rec, m) = _pair(small_model)
    for im, jim in zip(rec.images.values(), jrec.images.values()):
        noise = np.random.default_rng(im.id).normal(0, 0.4, im.xys.shape)
        im.xys = im.xys + noise
        jim.xys = jim.xys + noise
    assert m.filter_points(rec, 0.6, 1.5) == jm.filter_points(jrec, 0.6,
                                                              1.5) > 0
    _same_model(rec, jrec)
    assert m.complete_tracks(rec, 2.0) == jm.complete_tracks(jrec, 2.0) > 0
    _same_model(rec, jrec)
    assert m.retriangulate(rec) == jm.retriangulate(jrec) == len(jrec.points)
    _same_model(rec, jrec, atol=1e-4)


def test_relaxed_try_register_equals_jax(small_model):
    """tests/test_refiner.py's re-registration: strict thresholds fail,
    the relaxed ones register, with the JAX pose (atol 1e-4)."""
    (jrec, jm), (rec, m) = _pair(small_model)
    img_id = jrec.registered_images[-1]
    rec.deregister(img_id)
    jrec.deregister(img_id)
    assert not m._try_register(rec, img_id, min_num_inliers=10 ** 6)
    kw = dict(abs_pose_max_error=12.0, min_num_inliers=6,
              min_inlier_ratio=0.1)
    assert m._try_register(rec, img_id, **kw)
    assert jm._try_register(jrec, img_id, **kw)
    np.testing.assert_allclose(rec.images[img_id].tvec,
                               jrec.images[img_id].tvec, atol=1e-4)
    np.testing.assert_allclose(np.abs(rec.images[img_id].qvec),
                               np.abs(jrec.images[img_id].qvec), atol=1e-4)


def test_pack_track_table_and_bags_equal_jax(small_model):
    from detectorfreesfm_tpu.refine import bags as jb
    from detectorfreesfm_tpu_torch.refine import bags

    (jrec, _jm), (rec, _m) = _pair(small_model)
    a = bags.pack_track_table(rec, max_track_length=8)
    b = jb.pack_track_table(jrec, max_track_length=8)
    assert a.image_ids == b.image_ids and a.point_ids == b.point_ids
    for f in ("node_img", "node_xy", "node_scale", "node_mask", "node_kpt"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    kw = dict(max_track_length=8, max_imgs_per_bag=3, chunk_tracks=64)
    for x, y in zip(bags.pack_track_bags(rec, **kw),
                    jb.pack_track_bags(jrec, **kw)):
        assert x.image_ids == y.image_ids and x.point_ids == y.point_ids
        np.testing.assert_array_equal(x.node_xy, y.node_xy)


# --- refine/loop ----------------------------------------------------------------


def _scene_images(rec):
    rng = np.random.default_rng(5)
    base = rng.uniform(0, 1, (60, 80)).astype(np.float32)
    big = np.kron(base, np.ones((8, 8), np.float32))   # (480, 640) blocks
    return {i: np.roll(big, 3 * i, axis=1) for i in rec.images}


def test_one_refinement_iteration_equals_jax(small_model):
    """One iteration with the r4 weights at window 7 (crop 11), chunks of
    64 tracks of up to 8 views: the refined keypoints (atol 1e-3 px), then
    the same merge/complete/filter counts, registered set and point set,
    and points within 1e-3 scene units."""
    from detectorfreesfm_tpu.refine.loop import RefineConfig as JaxCfg
    from detectorfreesfm_tpu.refine.loop import (
        refine_reconstruction as jax_refine,
    )
    from detectorfreesfm_tpu.train.refiner_selfsup import (
        load_refiner_params as jax_load,
    )
    from detectorfreesfm_tpu_torch.refine.loop import (
        RefineConfig,
        refine_reconstruction,
    )

    (jrec, jm), (rec, m) = _pair(small_model)
    images = _scene_images(jrec)
    kw = dict(n_iters=1, windows=(7,), chunk_tracks=64, max_track_length=8,
              filter_thresholds=(3.0,))
    info = {}
    refine_reconstruction(rec, images, load_refiner_params(R4, device="cpu"),
                          RefineConfig(**kw), mapper=m, device="cpu",
                          info=info)
    jax_refine(jrec, images, jax_load(R4), JaxCfg(**kw), mapper=jm)
    assert info["iterations_completed"] == 1 and info["error"] is None
    import chip_smoke

    summary = chip_smoke.sfm_summary({"d": dict(info, wall_s=1.0)})
    assert summary["refine"][0]["merged"] == info["iterations"][0]["merged"]
    it = info["iterations"][0]
    assert it["chunks"] == -(-it["tracks"] // 64)
    assert it["median_shift_px"] > 0.01
    for i, im in jrec.images.items():
        np.testing.assert_allclose(rec.images[i].xys, im.xys, atol=1e-3)
    assert sorted(rec.registered_images) == sorted(jrec.registered_images)
    _same_model(rec, jrec, atol=1e-3)


def test_refinement_failure_restores_the_model(small_model, monkeypatch):
    """A failing geometry step restores the model the iteration started
    from and reports it: no iteration completed, and the error."""
    from detectorfreesfm_tpu_torch.refine.loop import (
        RefineConfig,
        refine_reconstruction,
    )

    (_jrec, _jm), (rec, m) = _pair(small_model)
    before = copy.deepcopy((
        {i: (im.qvec, im.tvec, im.xys, im.point3D_ids)
         for i, im in rec.images.items()},
        {p: (pt["xyz"], list(pt["track"])) for p, pt in rec.points.items()}))

    def boom(*a, **k):
        raise RuntimeError("BA exploded")

    monkeypatch.setattr(m, "global_ba", boom)
    info = {}
    cfg = RefineConfig(n_iters=2, windows=(7,), chunk_tracks=128,
                       max_track_length=4, allow_random_weights=True)
    out = refine_reconstruction(rec, _scene_images(rec), cfg=cfg, mapper=m,
                                device="cpu", info=info)
    assert out is rec
    assert info["iterations_completed"] == 0
    assert "BA exploded" in info["error"]
    imgs, pts = before
    for i, (q, t, xys, pids) in imgs.items():
        im = rec.images[i]
        np.testing.assert_array_equal(im.xys, xys)
        np.testing.assert_array_equal(im.point3D_ids, pids)
        np.testing.assert_array_equal(im.qvec, q)
        np.testing.assert_array_equal(im.tvec, t)
    assert set(rec.points) == set(pts)
    for p, (xyz, track) in pts.items():
        np.testing.assert_array_equal(rec.points[p]["xyz"], xyz)
        assert rec.points[p]["track"] == track


def test_refinement_needs_cuda_or_weights():
    from detectorfreesfm_tpu_torch.refine.loop import refine_reconstruction
    from detectorfreesfm_tpu_torch.sfm.reconstruction import Reconstruction

    with pytest.raises(ValueError, match="without refiner weights"):
        refine_reconstruction(Reconstruction(), {1: np.zeros((8, 8))},
                              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            refine_reconstruction(Reconstruction(), {1: np.zeros((8, 8))},
                                  params={})
