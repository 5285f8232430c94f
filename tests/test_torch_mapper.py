"""The port's incremental mapper against the JAX package's, on the same
inputs: whole runs on a synthetic scene (known and unknown intrinsics) and
on the cached demo matches (pair verification is held to JAX pair by pair
in tests/test_torch_refine.py, which shares the JAX mapper runs with this
file).

Run as a script, this file records the JAX numbers that chip_smoke.py's
sfm phase holds the card to: the JAX mapper on the dense fp32 JAX
engine's matches of generate_scene(seed=0, size=832, n_views=4) (with and
without the true intrinsics), on tests/data/demo_cached_832 and
tests/data/demo_cached, and two refinement iterations with the r4 refiner
on the known-intrinsics model (about 25 minutes on a CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_mapper.py --record
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

from detectorfreesfm_tpu.sfm.mapper import IncrementalMapper as JaxMapper  # noqa: E402
from detectorfreesfm_tpu.sfm.mapper import MapperConfig as JaxConfig  # noqa: E402
from detectorfreesfm_tpu_torch.sfm.mapper import (  # noqa: E402
    IncrementalMapper,
    MapperConfig,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's tests: the suite runs them beside
    other test workers on the same cores, where a pool of torch threads per
    worker slowed them ten- to twentyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _demo(which="demo_cached"):
    from detectorfreesfm_tpu.data.h5io import load_h5

    d = os.path.join(REPO, "tests", "data", which)
    kps = load_h5(os.path.join(d, "keypoints.h5"))
    raw = load_h5(os.path.join(d, "matches.h5"))
    return kps, {tuple(k.split("|")): v.astype(np.int32)
                 for k, v in raw.items()}


def _mean_reproj(rec):
    return float(np.mean(np.concatenate(
        list(rec.reprojection_errors().values()))))


def _scene_inputs(kind):
    from test_mapper import _multi_view_scene, _scene_to_matches

    pts, K, poses, uvs, visible = _multi_view_scene(6)
    kp, m = _scene_to_matches(6, uvs, visible)
    cfg = dict(geometry_verify_thr=4.0, init_max_error=4.0,
               abs_pose_max_error=4.0, filter_max_reproj_error=4.0,
               min_model_size=3, abs_pose_min_num_inliers=15)
    intr = {n: K for n in kp} if kind == "known" else None
    return kp, m, {n: (640, 480) for n in kp}, intr, cfg


def _demo_inputs():
    import chip_smoke

    kps, matches = _demo()
    return (kps, matches, {n: chip_smoke.DEMO_SIZES[n] for n in kps}, None,
            chip_smoke.demo_mapper_kwargs(kps, 416))


@pytest.mark.parametrize("kind", ["known", "unknown", "demo_cached"])
def test_mapper_run_equals_jax(kind):
    """A whole run: the same registered set, points within 1%, mean
    reprojection error within 0.05 px. tests/test_mapper.py's scene with
    known and unknown intrinsics, and demo_cached at 416 px with
    tests/test_demo_golden.py's config (JAX's BA under this suite's 8
    virtual devices, as the JAX golden test runs)."""
    kp, m, sizes, intr, cfg = (_demo_inputs() if kind == "demo_cached"
                               else _scene_inputs(kind))
    ref = JaxMapper(JaxConfig(**cfg)).run(kp, m, sizes, intr)
    mapper = IncrementalMapper(MapperConfig(**cfg), device="cpu")
    rec = mapper.run(kp, m, sizes, intr)
    assert ref is not None and rec is not None
    assert sorted(rec.registered_images) == sorted(ref.registered_images)
    assert abs(len(rec.points) - len(ref.points)) <= 0.01 * len(ref.points)
    assert abs(_mean_reproj(rec) - _mean_reproj(ref)) <= 0.05
    # every step of the run was timed
    assert {"verify", "init", "register", "triangulate", "ba",
            "filter"} <= set(mapper.times)


def test_mapper_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IncrementalMapper()


def test_smoke_sfm_gates_hold_the_card_to_jax():
    """chip_smoke.py's sfm gates accept the recorded JAX numbers and
    numbers just inside each tolerance; they reject each number just
    outside it, a refinement that stopped early, and a caught error."""
    import copy

    import chip_smoke

    ref = chip_smoke.JAX_SFM
    chip_smoke._check_sfm_gates(copy.deepcopy(ref), ref)

    def edited(edit):
        got = copy.deepcopy(ref)
        edit(got)
        return got

    near = edited(lambda g: (
        g["a_known"].update(n_points=ref["a_known"]["n_points"] + 80,
                            mean_reproj_px=ref["a_known"]["mean_reproj_px"]
                            + 0.04),
        g["a_unknown"]["rot_err_deg"].update(
            view_2=ref["a_unknown"]["rot_err_deg"]["view_2"] - 0.04),
        g["b"].update(n_points=ref["b"]["n_points"] - 23),
        g["c"].update(n_points=200, mean_reproj_px=7.9,
                      registered=g["c"]["registered"][:4]),
        g["d"].update(n_points=ref["d"]["n_points"] + 170,
                      median_shift_px_0=ref["d"]["median_shift_px_0"] * 1.04,
                      median_rot_err_deg=ref["d"]["median_rot_err_deg"]
                      + 0.04)))
    chip_smoke._check_sfm_gates(near, ref)
    bad = [
        lambda g: g["a_known"].update(registered=["view_0", "view_1",
                                                  "view_2"]),
        lambda g: g["a_known"].update(n_points=ref["a_known"]["n_points"]
                                      - 90),
        lambda g: g["a_unknown"].update(
            mean_reproj_px=ref["a_unknown"]["mean_reproj_px"] + 0.06),
        lambda g: g["a_known"]["rot_err_deg"].update(view_3=0.09),
        lambda g: g["b"].update(n_points=ref["b"]["n_points"] - 25),
        lambda g: g["b"].update(mean_reproj_px=5.1),
        lambda g: g["c"].update(n_points=199),
        lambda g: g["d"].update(iterations_completed=1),
        lambda g: g["d"].update(error="RuntimeError('CUDA error')"),
        lambda g: g["d"].update(n_points=ref["d"]["n_points"] - 175),
        lambda g: g["d"].update(mean_reproj_px=ref["d"]["mean_reproj_px"]
                                + 0.06),
        lambda g: g["d"].update(
            median_rot_err_deg=ref["d"]["median_rot_err_deg"] + 0.06),
        lambda g: g["d"].update(
            median_shift_px_0=ref["d"]["median_shift_px_0"] * 0.94),
        lambda g: g["d"].update(registered=["view_0", "view_1", "view_2"]),
    ]
    for edit in bad:
        with pytest.raises(RuntimeError, match="chip_smoke check failed"):
            chip_smoke._check_sfm_gates(edited(edit), ref)


# --- the script mode: JAX numbers for chip_smoke.py -------------------------


class JaxSfm:
    """The JAX package's mapper and refinement behind chip_smoke.PortSfm's
    interface. Refinement reports what the port's `info=` gives: the
    iterations completed, the caught error, and per iteration the tracks,
    the median query-keypoint shift and the merge/complete/filter counts."""

    def __init__(self):
        import chip_smoke
        from detectorfreesfm_tpu.train.refiner_selfsup import (
            load_refiner_params,
        )

        self.params = load_refiner_params(chip_smoke.REFINER_WEIGHTS)

    def mapper(self, **cfg):
        return JaxMapper(JaxConfig(**cfg))

    def refine(self, rec, images, mapper):
        import chip_smoke
        import detectorfreesfm_tpu.refine.loop as L

        info = dict(iterations=[], error=None)
        state, counts = {}, {}
        orig_iter, orig_pack = L._refine_iteration, L.pack_track_table

        def pack(*a, **k):
            state["table"] = orig_pack(*a, **k)
            return state["table"]

        for name in ("merge_tracks", "complete_tracks", "filter_points"):
            def wrapped(*a, _f=getattr(mapper, name), _n=name, **k):
                counts[_n] = _f(*a, **k)
                return counts[_n]
            setattr(mapper, name, wrapped)

        def iteration(rec, *a, **k):
            before = {i: im.xys.copy() for i, im in rec.images.items()}
            t0 = time.time()
            try:
                orig_iter(rec, *a, **k)
            except Exception as e:
                info["error"] = repr(e)
                raise
            tb = state["table"]
            r, v = np.nonzero(tb.node_mask[:, 1:])
            v = v + 1
            shift = [np.linalg.norm(rec.images[tb.image_ids[j]].xys[kp]
                                    - before[tb.image_ids[j]][kp])
                     for j, kp in zip(tb.node_img[r, v], tb.node_kpt[r, v])]
            info["iterations"].append(dict(
                tracks=len(tb.point_ids), median_shift_px=float(
                    np.median(shift)), merged=counts["merge_tracks"],
                completed=counts.get("complete_tracks", 0),
                filtered=counts["filter_points"], seconds=time.time() - t0))

        from detectorfreesfm_tpu.refine.loop import RefineConfig

        L._refine_iteration, L.pack_track_table = iteration, pack
        try:
            L.refine_reconstruction(
                rec, images, self.params,
                RefineConfig(n_iters=chip_smoke.SFM_REFINE_ITERS),
                mapper=mapper)
        finally:
            L._refine_iteration, L.pack_track_table = orig_iter, orig_pack
        info["iterations_completed"] = len(info["iterations"])
        return info


def record_jax_reference():
    """Print the JAX package's sfm numbers on the smoke's inputs."""
    import json

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from test_torch_engine import _jax_engine_matches, _scene

    from detectorfreesfm_tpu.ops.grid_merge import merge_matches_to_keypoints
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs

    t0 = time.time()
    images, _d, _K, _q, _t = _scene(832, 4)
    names = [f"view_{i}" for i in range(4)]
    raw = _jax_engine_matches(images, names, exhaustive_pairs(names), 832)
    keypoints, _s, match_indices = merge_matches_to_keypoints(raw)
    demo = {}
    for tag, which, side in (("b", "demo_cached_832", 832),
                             ("c", "demo_cached", 416)):
        demo[tag] = (*_demo(which), side)
    got, report = chip_smoke.sfm_reference(JaxSfm(), keypoints,
                                           match_indices, demo)
    print(json.dumps(dict(got, seconds=time.time() - t0,
                          wall_s={k: v["wall_s"] for k, v in report.items()},
                          refine=report["d"]["iterations"])), flush=True)


if __name__ == "__main__":
    if "--record" not in sys.argv:
        sys.exit("usage: python tests/test_torch_mapper.py --record")
    record_jax_reference()
