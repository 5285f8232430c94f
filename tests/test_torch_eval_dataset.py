"""The port's dataset evaluation against the JAX package's: known-pose
triangulation through reconstruct_scene, one refinement iteration with
fixed poses, and the `eval-dataset` verb in process and with
--isolate-scenes.

Run as a script, this file records the JAX numbers that chip_smoke.py's
eval phase holds the card to: the JAX package's own `cli eval-dataset
--triangulation --known-intrinsics --imc-bags`, with its defaults off the
TPU (dense matching, batch 1, the bundled r5 matcher and r4 refiner,
coarse_fine, two refinement iterations), on the smoke's two-scene dataset
written by chip_smoke.write_eval_dataset (about 53 minutes on a CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_eval_dataset.py --record
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
from detectorfreesfm_tpu_torch import cli as port_cli  # noqa: E402
from detectorfreesfm_tpu_torch import pipeline as TP  # noqa: E402
from detectorfreesfm_tpu_torch.data import colmap_io  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's tests: the suite runs them beside
    other test workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stored_poses(model_dir):
    """{name: (qvec, tvec)} of a written model's registered images."""
    _cams, imgs, _pts = colmap_io.read_model(str(model_dir))
    return {im.name: (im.qvec, im.tvec) for im in imgs.values()}


# --- known-pose triangulation through reconstruct_scene ----------------------


@pytest.fixture(scope="module")
def triangulation_scene(tmp_path_factory):
    """tests/test_eval_dataset.py's triangulation scene (4 cameras, 200
    points, seed 77) with its cached matches, its images written as PNG by
    the port's writer, and the true poses and K."""
    from test_mapper import _multi_view_scene, _scene_to_matches

    from detectorfreesfm_tpu_torch.core.geometry import np_rotmat_to_quat
    from detectorfreesfm_tpu_torch.data.h5io import save_h5
    from detectorfreesfm_tpu_torch.data.png import write_png

    root = tmp_path_factory.mktemp("tri")
    pts, K, poses, uvs, visible = _multi_view_scene(4, n_pts=200, seed=77)
    keypoints, matches = _scene_to_matches(4, uvs, visible)
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    for n in keypoints:
        write_png(str(root / "images" / f"{n}.png"),
                  rng.integers(0, 255, (480, 640), dtype=np.uint8))
    stores = {}
    for tag in ("jax", "port"):
        out = root / tag
        out.mkdir()
        save_h5({f"{n}.png": v for n, v in keypoints.items()},
                str(out / "keypoints.h5"))
        save_h5({f"{a}.png|{b}.png": v for (a, b), v in matches.items()},
                str(out / "matches.h5"))
        stores[tag] = out
    pose_in = {f"im{i:02d}.png": (np_rotmat_to_quat(poses[i][0]),
                                  poses[i][1]) for i in range(4)}
    intrins = {f"{n}.png": K for n in keypoints}
    return root / "images", stores, pose_in, intrins, pts


def test_triangulation_mode_equals_jax(triangulation_scene):
    """reconstruct_scene(triangulation_mode=True) on cached matches with no
    refinement, against the JAX package's: the same registered set, points
    within 1%, every pose equal to its input within 1e-5 (BA's float32
    round trip), and the ETH3D accuracy/completeness against the true
    points as the JAX test's bounds."""
    from detectorfreesfm_tpu_torch.eval.pointcloud import (
        accuracy_completeness,
    )

    image_dir, stores, pose_in, intrins, pts = triangulation_scene
    recs = {}
    for tag, mod in (("jax", JP), ("port", TP)):
        cfg = mod.PipelineConfig(
            img_resize=640, n_refine_iters=0, triangulation_mode=True,
            mapper=mod.MapperConfig(abs_pose_min_num_inliers=10))
        kw = {"device": "cpu"} if tag == "port" else {}
        recs[tag] = mod.reconstruct_scene(
            str(image_dir), str(stores[tag]), cfg, intrinsics=intrins,
            poses=pose_in, **kw)
    trec, jrec = recs["port"], recs["jax"]
    names = sorted(pose_in)
    for rec in (trec, jrec):
        assert sorted(rec.images[i].name
                      for i in rec.registered_images) == names
    assert len(jrec.points) > 100
    assert abs(len(trec.points) - len(jrec.points)) <= 0.01 * len(
        jrec.points), (len(trec.points), len(jrec.points))
    for rec in (trec, _stored_poses(stores["port"] / "colmap_coarse")):
        for n, (q, t) in pose_in.items():
            got = (rec.image_by_name(n).qvec, rec.image_by_name(n).tvec) if (
                hasattr(rec, "image_by_name")) else rec[n]
            np.testing.assert_allclose(got[0], q, rtol=0, atol=1e-5)
            np.testing.assert_allclose(got[1], t, rtol=0, atol=1e-5)
    est = np.stack([p["xyz"] for p in trec.points.values()])
    m = accuracy_completeness(est, pts, tolerances=(0.05, 0.1),
                              device="cpu")
    assert m["accuracy@0.1"] > 0.9 and m["completeness@0.1"] > 0.5, m


def test_triangulation_needs_poses(tmp_path):
    """Without poses the mode raises (as JAX's), before any work: in
    reconstruct_scene and in the verb given --images (no poses/)."""
    scene = tmp_path / "scene"
    chip_smoke.write_scene(str(scene), size=64, n_views=2)
    with pytest.raises(ValueError, match="requires poses"):
        TP.reconstruct_scene(str(scene / "images"), str(tmp_path / "o1"),
                             TP.PipelineConfig(triangulation_mode=True),
                             device="cpu")
    with pytest.raises(ValueError, match="requires poses"):
        port_cli.main(["reconstruct", "--images", str(scene / "images"),
                       "--output", str(tmp_path / "o2"), "--triangulation",
                       "--device", "cpu", "--refine-iters", "0"])
    assert not (tmp_path / "o1").exists() and not (tmp_path / "o2").exists()


# --- the eval-dataset verb ---------------------------------------------------


def test_eval_dataset_needs_cuda_by_default(tmp_path, monkeypatch):
    """--device defaults to cuda: without a card the verb raises before
    any scene, instead of reporting every scene as failed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chip_smoke.write_scene(str(tmp_path / "d" / "s0"), size=64, n_views=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["eval-dataset", "--dataset", str(tmp_path / "d"),
                       "--output", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def _staged_dataset(tmp_path, n_scenes, outs):
    """tests/test_eval_dataset.py's dataset (scenes scene{k}_5bag of 4
    cameras, poses/ and intrins/), with each scene's cached matches copied
    into every output dir of `outs`."""
    import shutil

    from test_eval_dataset import _stage_dataset

    root = _stage_dataset(tmp_path, n_scenes=n_scenes)
    for out in outs:
        for k in range(n_scenes):
            dst = out / f"scene{k}_5bag"
            dst.mkdir(parents=True)
            for f in ("keypoints.h5", "matches.h5"):
                shutil.copy(root / f"scene{k}_5bag" / "out" / f, dst / f)
    return root


def test_eval_dataset_equals_jax_cli(tmp_path):
    """Both CLIs' eval-dataset in known-pose triangulation mode on two
    scenes with cached matches, no refinement: the same metrics.txt but
    for wall_s ([all], [5bag] and per scene), per scene the same
    registered set, points and observations within 1%, and every pose as
    in poses/ within 1e-5."""
    outs = {"jax": tmp_path / "jax_out", "port": tmp_path / "port_out"}
    root = _staged_dataset(tmp_path, 2, outs.values())
    argv = ("--img-resize", "640", "--refine-iters", "0",
            "--known-intrinsics", "--imc-bags", "--triangulation")
    ref, _ = chip_smoke.run_eval_dataset(jax_cli.main, str(root),
                                         str(outs["jax"]), *argv)
    got, _ = chip_smoke.run_eval_dataset(port_cli.main, str(root),
                                         str(outs["port"]), *argv,
                                         "--device", "cpu")
    assert sorted(got["metrics"]) == ["5bag", "all", "per_scene"]
    assert chip_smoke.without_wall(got["metrics"]) == chip_smoke.without_wall(
        ref["metrics"])
    assert got["metrics"]["all"]["auc@5"] > 0.99
    assert sorted(got["scenes"]) == ["scene0_5bag", "scene1_5bag"]
    for s, r in ref["scenes"].items():
        g = got["scenes"][s]
        assert g["result"]["status"] == r["result"]["status"] == "ok"
        for m in ("coarse", "refined"):
            assert g[m]["registered"] == r[m]["registered"]
            for k in ("n_points", "n_observations"):
                assert abs(g[m][k] - r[m][k]) <= 0.01 * r[m][k], (s, m, k)
        true = JP.reconstruct_scene.__globals__["read_pose_txt"]
        for n, (q, t) in _stored_poses(outs["port"] / s /
                                       "colmap_refined").items():
            q0, t0 = true(str(root / s / "poses" / (n[:-4] + ".txt")))
            np.testing.assert_allclose(q, q0, rtol=0, atol=1e-5)
            np.testing.assert_allclose(t, t0, rtol=0, atol=1e-5)


def test_isolate_scenes_propagates_full_config(tmp_path, monkeypatch):
    """test_eval_dataset.py's check, on the port's verb: with
    --isolate-scenes the child's _scene_args.json carries every
    non-default option (and --device), and the isolated run gives the
    in-process run's model and metrics."""
    import json

    # The child, like this file's tests, runs torch on one thread.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    outs = {m: tmp_path / f"out_{m}" for m in ("inproc", "isolated")}
    root = _staged_dataset(tmp_path, 1, outs.values())
    scene = "scene0_5bag"
    argv = ["eval-dataset", "--dataset", str(root),
            "--img-resize", "640", "--refine-iters", "0",
            "--known-intrinsics", "--min-inliers", "12",
            "--min-tri-angle", "1.0", "--match-threshold", "0.35",
            "--pair-mode", "sequential", "--min-model-size", "4",
            "--device", "cpu"]
    got = {}
    for mode, out in outs.items():
        extra = ["--isolate-scenes", "--scene-timeout", "600"] if (
            mode == "isolated") else []
        got[mode], _ = chip_smoke.run_eval_dataset(
            port_cli.main, str(root), str(out), *argv[3:], *extra)
    blob = json.loads(
        (outs["isolated"] / scene / "_scene_args.json").read_text())
    assert blob["min_inliers"] == 12
    assert blob["min_tri_angle"] == 1.0
    assert blob["match_threshold"] == 0.35
    assert blob["pair_mode"] == "sequential"
    assert blob["min_model_size"] == 4
    assert blob["known_intrinsics"] is True
    assert blob["refine_iters"] == 0
    assert blob["device"] == "cpu"
    assert blob["output"] == str(outs["isolated"] / scene)
    assert chip_smoke.without_wall(got["isolated"]["metrics"]) == (
        chip_smoke.without_wall(got["inproc"]["metrics"]))
    a, b = (colmap_io.read_model(str(outs[m] / scene / "colmap_coarse"))
            for m in ("inproc", "isolated"))
    assert set(a[1]) == set(b[1]) and len(a[2]) == len(b[2])
    for i in a[1]:
        np.testing.assert_allclose(a[1][i].qvec, b[1][i].qvec, atol=1e-5)
        np.testing.assert_allclose(a[1][i].tvec, b[1][i].tvec, atol=1e-5)


def test_isolated_scene_is_retried_once_and_reported(tmp_path, monkeypatch):
    """A child that crashes (no result line) is retried once and then
    reported failed; a clean result line, even status=failed, is final;
    an option that is not JSON raises before any child starts."""
    import argparse
    import subprocess

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        stdout = "" if len(calls) < 3 else '{"status": "failed"}\n'
        return subprocess.CompletedProcess(cmd, 1, stdout, "boom")

    monkeypatch.setattr(subprocess, "run", run)
    ns = argparse.Namespace(output=str(tmp_path / "s"), device="cpu",
                            fn=None, isolate_scenes=True, args_json=None)
    assert port_cli._run_isolated(ns, "s", 5) == {"status": "failed",
                                                  "error": "boom"}
    assert len(calls) == 2
    assert calls[0][1:4] == ["-m", "detectorfreesfm_tpu_torch.cli",
                             "reconstruct"]
    assert port_cli._run_isolated(ns, "s", 5) == {"status": "failed"}
    assert len(calls) == 3
    ns.extra = object()
    with pytest.raises(SystemExit, match="cannot serialize option extra"):
        port_cli._run_isolated(ns, "s", 5)
    assert len(calls) == 3


def record_jax_eval(work):
    """JAX_EVAL: the JAX CLI's per-scene result lines, reconstruct_numbers
    of each scene and its metrics.txt, on chip_smoke's eval dataset
    written under `work`; with the run's wall and stage times."""
    jax.config.update("jax_platforms", "cpu")
    from detectorfreesfm_tpu import cli as jax_cli

    dataset = os.path.join(work, "dataset")
    chip_smoke.write_eval_dataset(dataset)
    return chip_smoke.run_eval_dataset(
        jax_cli.main, dataset, os.path.join(work, "jax_out"),
        *chip_smoke.EVAL_ARGS)


if __name__ == "__main__":
    import argparse
    import tempfile

    ap = argparse.ArgumentParser()
    ap.add_argument("--record", action="store_true", required=True)
    ap.add_argument("--work", default=None,
                    help="keep the dataset and the JAX output here")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        got, run = record_jax_eval(args.work or d)
    print(json.dumps(got), flush=True)
    print(json.dumps(run), flush=True)


# --- the smoke's eval gates -----------------------------------------------


def test_smoke_eval_gates_hold_the_card_to_jax():
    """chip_smoke.py's E1 gates accept JAX_EVAL (with the two refinement
    iterations and the poses a card run must show) and reject a scene
    missing, a pose moved by 2e-5, points beyond 1%, a registered image
    lost, and a metrics.txt key changed in [all], [3bag] or a scene's
    line; wall_s is not compared."""
    import copy

    ref = chip_smoke.JAX_EVAL
    assert sorted(ref["scenes"]) == [s for s, _ in chip_smoke.EVAL_SCENES]
    base = copy.deepcopy(ref)
    for g in base["scenes"].values():
        g["result"]["refine_iterations_completed"] = 2  # the port's key
    poses = {s: dict(n_images=chip_smoke.EVAL_VIEWS, qvec=1e-6, tvec=1e-6)
             for s in ref["scenes"]}
    chip_smoke._check_eval_gates(copy.deepcopy(base), ref, poses)
    s0 = chip_smoke.EVAL_SCENES[0][0]
    timing = copy.deepcopy(base)
    timing["metrics"]["all"]["wall_s"] += 100.0
    chip_smoke._check_eval_gates(timing, ref, poses)

    def edited(edit):
        g = copy.deepcopy(base)
        edit(g)
        return g

    c = ref["scenes"][s0]["coarse"]
    bad = [
        lambda g: g["scenes"].pop(s0),
        lambda g: g["scenes"][s0]["coarse"].update(
            n_points=c["n_points"] + int(0.01 * c["n_points"]) + 1),
        lambda g: g["scenes"][s0]["refined"].update(
            registered=c["registered"][1:]),
        lambda g: g["scenes"][s0]["result"].update(
            refine_iterations_completed=1),
        lambda g: g["metrics"]["all"].update(registered_ratio=0.75),
        lambda g: g["metrics"]["3bag"].update({"auc@5": 0.9}),
        lambda g: g["metrics"]["per_scene"][s0].update({"auc@1": 0.5}),
    ]
    for edit in bad:
        with pytest.raises(RuntimeError, match="chip_smoke check failed"):
            chip_smoke._check_eval_gates(edited(edit), ref, poses)
    moved = dict(poses, **{s0: dict(poses[s0], tvec=2e-5)})
    with pytest.raises(RuntimeError, match="poses moved"):
        chip_smoke._check_eval_gates(copy.deepcopy(base), ref, moved)


def test_parse_metrics_reads_format_report(tmp_path):
    """parse_metrics reads the port's format_report back: every group,
    the per-scene lines and the unequal-counts warning."""
    from detectorfreesfm_tpu_torch.eval.aggregate import (
        aggregate_multi_scene_metrics, format_report)

    per_scene = {"a_3bag": {"auc@5": 0.5, "wall_s": 3.0},
                 "b_3bag": {"auc@5": 0.25}}
    agg = aggregate_multi_scene_metrics(per_scene, group_bags=True)
    got = chip_smoke.parse_metrics(format_report(agg, per_scene))
    assert got["all"] == {"auc@5": 0.375, "wall_s": 3.0,
                          "(warning: warning_unequal_counts)": None}
    assert got["3bag"] == got["all"]
    assert got["per_scene"] == per_scene
    assert chip_smoke.without_wall(got)["per_scene"]["a_3bag"] == {
        "auc@5": 0.5}
