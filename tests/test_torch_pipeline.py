"""The port's scene pipeline and `reconstruct` verb against the JAX
package's, on the same files.

Run as a script, this file records the JAX numbers that chip_smoke.py's
reconstruct phase holds the card to: the JAX package's own `cli
reconstruct`, with its defaults off the TPU (dense matching, batch 1, the
bundled r5 matcher and r4 refiner, coarse_fine, two refinement
iterations), on the smoke's 4-view 1040 px scene written by
chip_smoke.write_scene (about half an hour on a CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_pipeline.py --record

With `--dtype bfloat16` the JAX CLI runs with `--dtype bfloat16` on the
same files: JAX_RECONSTRUCT_BF16, the smoke's `bf16` run A.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from detectorfreesfm_tpu import cli as jax_cli  # noqa: E402
from detectorfreesfm_tpu import pipeline as JP  # noqa: E402
from detectorfreesfm_tpu.eval import pose_auc as JA  # noqa: E402
from detectorfreesfm_tpu.sfm import reconstruction as JR  # noqa: E402
from detectorfreesfm_tpu.utils import vis as JV  # noqa: E402
from detectorfreesfm_tpu_torch import pipeline as TP  # noqa: E402
from detectorfreesfm_tpu_torch.eval import pose_auc as TA  # noqa: E402
from detectorfreesfm_tpu_torch.sfm import reconstruction as TR  # noqa: E402
from detectorfreesfm_tpu_torch.utils import vis as TV  # noqa: E402

REFINER = os.path.join(REPO, "weights", "demo_refiner_r4_bf16.msgpack")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's tests: the suite runs them beside
    other test workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- evaluation and exports: exact copies -----------------------------------


def _random_poses(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q, rng.normal(size=(n, 3))


def test_pose_auc_equals_jax():
    """pose_auc, all_pairs_relative_errors and evaluate_poses (with
    unregistered images and infinite errors) to 1e-12."""
    rng = np.random.default_rng(0)
    errs = np.concatenate([rng.exponential(4.0, 200), [np.inf] * 7, [0.0]])
    assert TA.DEFAULT_THRESHOLDS == JA.DEFAULT_THRESHOLDS
    for th in (JA.DEFAULT_THRESHOLDS, (0.5, 2, 30)):
        np.testing.assert_allclose(TA.pose_auc(errs, th),
                                   JA.pose_auc(errs, th), rtol=0, atol=1e-12)
    assert TA.pose_auc([], (1, 5)) == JA.pose_auc([], (1, 5))
    qg, tg = _random_poses(rng, 9)
    qe = qg + rng.normal(0, 0.01, qg.shape)
    te = tg + rng.normal(0, 0.05, tg.shape)
    reg = rng.random(9) < 0.8
    np.testing.assert_allclose(
        TA.all_pairs_relative_errors(qe, te, reg, qg, tg),
        JA.all_pairs_relative_errors(qe, te, reg, qg, tg), rtol=0,
        atol=1e-12)
    names = [f"im{i}" for i in range(9)]
    gt = {n: (qg[i], tg[i]) for i, n in enumerate(names)}
    est = {n: (qe[i], te[i]) for i, n in enumerate(names) if reg[i]}
    a, b = TA.evaluate_poses(est, gt), JA.evaluate_poses(est, gt)
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-12, k


def _two_recs(rng, n_images=6, n_points=40, unregistered=(2,)):
    """The same model built in both packages' Reconstruction."""
    from detectorfreesfm_tpu.data import colmap_io as JC
    from detectorfreesfm_tpu_torch.data import colmap_io as TC

    q, t = _random_poses(rng, n_images)
    xyz = rng.normal(size=(n_points, 3))
    rgb = rng.integers(0, 256, (n_points, 3)).astype(np.uint8)
    out = []
    for R, C in ((JR, JC), (TR, TC)):
        rec = R.Reconstruction()
        rec.add_camera(C.Camera(1, "PINHOLE", 640, 480,
                                np.array([500.0, 500, 320, 240])))
        for i in range(n_images):
            rec.add_image(R.RImage(i + 1, f"im{i}.png", 1,
                                   rng.uniform(0, 480, (n_points, 2))))
            if i not in unregistered:
                rec.set_pose(i + 1, q[i], t[i])
        for p in range(n_points):
            pid = rec.add_point(xyz[p], [(1, p), (4, p)])
            rec.points[pid]["rgb"] = rgb[p]
        out.append(rec)
    return out, q, t


def test_evaluate_scene_poses_equals_jax():
    """The scene-level AUCs, an unregistered image counting as inf."""
    rng = np.random.default_rng(1)
    (jrec, trec), q, t = _two_recs(rng)
    gt = {f"im{i}.png": (q[i] + 0.003 * i, t[i]) for i in range(len(q))}
    a = TP.evaluate_scene_poses(trec, gt)
    b = JP.evaluate_scene_poses(jrec, gt)
    assert a.keys() == b.keys() and set(a) == {
        f"auc@{x}" for x in TA.DEFAULT_THRESHOLDS}
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-12, k


def test_export_reconstruction_ply_equals_jax(tmp_path):
    """Points and camera frusta as the JAX export writes them: the same
    header, vertex count, colours and point coordinates, byte for byte;
    the camera centres and frustum corners within 1e-5 (the JAX export
    builds its rotations in float32, the port in float64)."""
    rng = np.random.default_rng(2)
    (jrec, trec), _q, _t = _two_recs(rng, n_images=9, unregistered=(3, 7))
    JV.export_reconstruction_ply(jrec, str(tmp_path / "j.ply"))
    TV.export_reconstruction_ply(trec, str(tmp_path / "t.ply"))
    j, t = ((tmp_path / f).read_bytes() for f in ("j.ply", "t.ply"))
    end = b"end_header\n"
    head = j[:j.index(end) + len(end)]
    assert t[:len(head)] == head
    dt = np.dtype([("xyz", "<f8", 3), ("rgb", "u1", 3)])
    jv, tv = (np.frombuffer(x[len(head):], dt) for x in (j, t))
    assert len(tv) == len(jv) == len(jrec.points) + 5 * 7
    np.testing.assert_array_equal(tv["rgb"], jv["rgb"])
    n = len(jrec.points)
    np.testing.assert_array_equal(tv["xyz"][:n], jv["xyz"][:n])
    np.testing.assert_allclose(tv["xyz"][n:], jv["xyz"][n:], rtol=0,
                               atol=1e-5)


# --- reconstruct_scene on cached matches -----------------------------------


def _cached_cfg(module, refine_iters=1):
    """tests/test_pipeline.py's configuration of its cached-match scene,
    in either package, with trained weights instead of random ones."""
    return module.PipelineConfig(
        img_resize=640, n_refine_iters=refine_iters,
        mapper=module.MapperConfig(abs_pose_min_num_inliers=15),
        refine=module.RefineConfig(
            windows=(9,), chunk_tracks=128, filter_thresholds=(8.0,)))


def _track_colours(rec):
    """{frozenset of (image name, keypoint): rgb} of a model's points."""
    names = {i: im.name for i, im in rec.images.items()}
    return {frozenset((names[i], int(k)) for i, k in pt["track"]):
            tuple(int(c) for c in pt["rgb"]) for pt in rec.points.values()}


def _listing(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _ds, fs in os.walk(d) for f in fs)


def test_reconstruct_scene_equals_jax(tmp_path, monkeypatch):
    """reconstruct_scene on the CPU against the JAX package's, on
    tests/test_pipeline.py's cached-match scene with one refinement
    iteration and the r4 refiner: the same registered set, points within
    1%, the same colour on every point both models hold, the same files;
    then a resuming run reads the stored models and builds no engine."""
    from test_pipeline import _stage_scene

    from detectorfreesfm_tpu.train.refiner_selfsup import (
        load_refiner_params as jax_refiner,
    )
    from detectorfreesfm_tpu_torch.utils.checkpoint import (
        load_refiner_params,
    )

    runs = {}
    for tag in ("jax", "port"):
        (tmp_path / tag).mkdir()
        image_dir, out_dir, intrins, gt = _stage_scene(tmp_path / tag)
        if tag == "jax":
            rec = JP.reconstruct_scene(
                str(image_dir), str(out_dir), _cached_cfg(JP),
                intrinsics=intrins, refiner_params=jax_refiner(REFINER))
        else:
            info = {}
            rec = TP.reconstruct_scene(
                str(image_dir), str(out_dir), _cached_cfg(TP),
                intrinsics=intrins, device="cpu",
                refiner_params=load_refiner_params(REFINER, device="cpu"),
                info=info)
            assert info == dict(refine_iterations_completed=1,
                                refine_error=None, refine_device_error=False)
        runs[tag] = (rec, out_dir, image_dir, intrins, gt)
    (jrec, jout, *_), (trec, tout, image_dir, intrins, gt) = (
        runs["jax"], runs["port"])
    reg = sorted(trec.images[i].name for i in trec.registered_images)
    assert reg == sorted(jrec.images[i].name
                         for i in jrec.registered_images)
    assert len(reg) == 5
    assert abs(len(trec.points) - len(jrec.points)) <= 0.01 * len(
        jrec.points), (len(trec.points), len(jrec.points))
    tc, jc = _track_colours(trec), _track_colours(jrec)
    common = tc.keys() & jc.keys()
    assert len(common) >= 0.98 * len(jc)
    assert all(tc[k] == jc[k] for k in common)
    tn = chip_smoke.reconstruct_numbers(str(tout))
    jn = chip_smoke.reconstruct_numbers(str(jout))
    for m in ("coarse", "refined"):
        assert tn[m]["registered"] == jn[m]["registered"]
        assert tn[m]["grey_fraction"] < 0.5
    assert _listing(tout) == _listing(jout)
    with open(tout / "stage_times.json") as f:
        assert set(json.load(f)) == set(chip_smoke.STAGE_KEYS)
    assert abs(TP.evaluate_scene_poses(trec, gt)["auc@5"]
               - JP.evaluate_scene_poses(jrec, gt)["auc@5"]) <= 0.02

    # Resume: the stored matches and models are read back, no engine is
    # built and nothing is matched again.
    def no_engine(*a, **k):
        raise AssertionError("the resuming run built a matching engine")

    monkeypatch.setattr(TP, "PairMatchingEngine", no_engine)
    stores = [tout / "keypoints.h5", tout / "matches.h5"]
    before = [os.path.getmtime(TP.stored_path(str(p))) for p in stores]
    info = {}
    rec2 = TP.reconstruct_scene(str(image_dir), str(tout),
                                _cached_cfg(TP, refine_iters=0),
                                intrinsics=intrins, device="cpu", info=info)
    # the stored refined model and its one model_refined_0/
    assert info["refine_iterations_completed"] == 1
    assert sorted(rec2.images[i].name for i in rec2.registered_images) == reg
    assert len(rec2.points) == len(trec.points)
    assert before == [os.path.getmtime(TP.stored_path(str(p)))
                      for p in stores]


@pytest.mark.parametrize("error,device_error", [
    (RuntimeError("cusolver error: CUSOLVER_STATUS_INVALID_VALUE, when "
                  "calling `cusolverDnXsyevBatched`"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), True),
    (RuntimeError("Expected all tensors to be on the same device, but "
                  "found at least two devices, cuda:0 and cpu!"), False),
    (np.linalg.LinAlgError("Singular matrix"), False),
    (ValueError("too few tracks to refine"), False)])
def test_refine_loop_reports_a_device_fault(error, device_error,
                                            monkeypatch):
    """A failed iteration restores the model and ends the loop; `info`
    says whether the card or the data failed (device.is_device_error)."""
    from detectorfreesfm_tpu_torch.device import is_device_error
    from detectorfreesfm_tpu_torch.refine import loop

    def fail(*a, **k):
        raise error

    monkeypatch.setattr(loop, "_refine_iteration", fail)
    (_jrec, trec), _q, _t = _two_recs(np.random.default_rng(4))
    before = {i: im.xys.copy() for i, im in trec.images.items()}
    info = {}
    loop.refine_reconstruction(
        trec, {i: np.zeros((8, 8), np.float32) for i in trec.images},
        params={}, cfg=loop.RefineConfig(n_iters=2), device="cpu",
        info=info)
    assert info["iterations_completed"] == 0
    assert info["error"] == repr(error)
    assert info["device_error"] is device_error is is_device_error(error)
    for i, im in trec.images.items():
        np.testing.assert_array_equal(im.xys, before[i])


# --- the smoke's gates ------------------------------------------------------


def test_smoke_reconstruct_gates_hold_the_card_to_jax():
    """chip_smoke.py's reconstruct gates accept JAX_RECONSTRUCT (with the
    launches, files and completed refinement iterations a run A must show)
    and values just inside each bound, and reject each value just
    outside."""
    import copy

    ref = chip_smoke.JAX_RECONSTRUCT
    base = dict(copy.deepcopy(ref), missing_files=[],
                launches={"dsm_pass1": 1, "dsm_pass2": 1})
    base["result"]["refine_iterations_completed"] = 2  # the port's key
    chip_smoke._check_reconstruct_gates(copy.deepcopy(base), ref)

    def edited(edit):
        g = copy.deepcopy(base)
        edit(g)
        return g

    c, f = ref["coarse"], ref["refined"]
    auc5 = ref["result"]["pose_auc"]["auc@5"]
    near = edited(lambda g: (
        g["coarse"].update(n_points=c["n_points"]
                           + int(0.01 * c["n_points"])),
        g["refined"].update(
            n_points=f["n_points"] - int(0.02 * f["n_points"]),
            n_observations=f["n_observations"]
            + int(0.02 * f["n_observations"]),
            mean_reproj_px=f["mean_reproj_px"] + 0.049,
            grey_fraction=0.49),
        g["result"]["pose_auc"].update({"auc@5": auc5 - 0.0199})))
    chip_smoke._check_reconstruct_gates(near, ref)
    bad = [
        lambda g: g.update(launches={"dsm_pass1": 0, "dsm_pass2": 1}),
        lambda g: g.update(launches={"dsm_pass1": 1, "dsm_pass2": 2}),
        lambda g: g.update(missing_files=["model_refined_1/images.bin"]),
        lambda g: g["result"].update(status="failed"),
        lambda g: g["result"].update(refine_iterations_completed=1),
        lambda g: g["coarse"].update(registered=c["registered"][:-1]),
        lambda g: g["coarse"].update(
            n_points=c["n_points"] + int(0.01 * c["n_points"]) + 1),
        lambda g: g["refined"].update(registered=f["registered"][1:]),
        lambda g: g["refined"].update(
            n_points=f["n_points"] - int(0.02 * f["n_points"]) - 1),
        lambda g: g["refined"].update(
            n_observations=f["n_observations"]
            + int(0.02 * f["n_observations"]) + 1),
        lambda g: g["refined"].update(
            mean_reproj_px=f["mean_reproj_px"] - 0.051),
        lambda g: g["refined"].update(grey_fraction=0.5),
        lambda g: g["result"]["pose_auc"].update({"auc@5": auc5 + 0.021}),
    ]
    for edit in bad:
        with pytest.raises(RuntimeError, match="chip_smoke check failed"):
            chip_smoke._check_reconstruct_gates(edited(edit), ref)


def test_written_files_names_what_is_missing(tmp_path):
    """The files gate: every model, export and store at the path the store
    writes, and the four stage keys."""
    out = tmp_path / "out"
    for f in chip_smoke.RECON_FILES:
        (out / f).parent.mkdir(parents=True, exist_ok=True)
        (out / f).write_text("{}")
    (out / "stage_times.json").write_text(json.dumps(
        dict.fromkeys(chip_smoke.STAGE_KEYS, 1.0)))
    from detectorfreesfm_tpu_torch.data.h5io import save_h5

    for p in TP.match_stores(str(out)):
        save_h5({"a": np.zeros(2)}, p)
    assert chip_smoke.written_files(str(out)) == []
    os.remove(out / "model_refined_1" / "images.bin")
    (out / "stage_times.json").write_text(json.dumps({"match": 1.0}))
    missing = chip_smoke.written_files(str(out))
    assert "model_refined_1/images.bin" in missing
    assert "stage_times.json:refine" in missing and len(missing) == 4


# --- the script mode: JAX numbers for chip_smoke.py -------------------------


def record_jax_reference(work, size=None, n_views=None, extra=()):
    """JAX_RECONSTRUCT: the JAX CLI's result line and the numbers that
    chip_smoke.reconstruct_numbers reads from its output, on a scene that
    chip_smoke.write_scene writes under `work` (by default the smoke's
    run A scene); with the run's stage times."""
    jax.config.update("jax_platforms", "cpu")
    import chip_smoke

    from detectorfreesfm_tpu import cli as jax_cli

    scene = os.path.join(work, "scene")
    chip_smoke.write_scene(scene, size=size or chip_smoke.RECON_SIZE,
                           n_views=n_views or chip_smoke.RECON_VIEWS)
    return chip_smoke.run_reconstruct(jax_cli.main, scene,
                                      os.path.join(work, "jax_out"), *extra)


if __name__ == "__main__":
    import argparse
    import tempfile

    ap = argparse.ArgumentParser()
    ap.add_argument("--record", action="store_true", required=True)
    ap.add_argument("--work", default=None,
                    help="keep the scene and the JAX output here")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args()
    import json

    extra = () if args.dtype == "float32" else ("--dtype", args.dtype)
    with tempfile.TemporaryDirectory() as d:
        got, run = record_jax_reference(args.work or d, extra=extra)
    print(json.dumps(got), flush=True)
    print(json.dumps(run), flush=True)
