"""The port's `reconstruct` verb against the JAX package's `cli
reconstruct` on the same PNG files, and what the verb refuses.

The parity run: chip_smoke.write_scene's generator at 256 px, 3 views,
matched at 176 px (so the resize, the threshold scaling and the rescale
around refinement all run), --device cpu against the JAX CLI's CPU
defaults, the bundled r5 matcher and r4 refiner, one refinement iteration
with a 7 px window. Tolerances as the smoke's run A gates: the same
registered sets, points within 2%, AUC@5 within 0.02.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from detectorfreesfm_tpu_torch import cli as port_cli  # noqa: E402
from detectorfreesfm_tpu_torch import pipeline as TP  # noqa: E402
from test_torch_pipeline import record_jax_reference  # noqa: E402

VERB_ARGS = ("--refine-iters", "1", "--img-resize", "176",
             "--refine-windows", "7")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's tests: the suite runs them beside
    other test workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_verb_equals_jax_cli(tmp_path):
    """Both CLIs on the same files (written by the record script's own
    path): registered sets equal, points and observations within 2%, mean
    reprojection within 0.05 px, AUC@5 within 0.02, the same files."""
    ref, _run = record_jax_reference(str(tmp_path), size=256, n_views=3,
                                     extra=VERB_ARGS)
    out = str(tmp_path / "port_out")
    got, run = chip_smoke.run_reconstruct(
        port_cli.main, str(tmp_path / "scene"), out, "--device", "cpu",
        *VERB_ARGS)
    assert got["result"]["status"] == ref["result"]["status"] == "ok"
    assert got["result"]["n_registered"] == ref["result"]["n_registered"] == 3
    for m in ("coarse", "refined"):
        g, r = got[m], ref[m]
        assert g["registered"] == r["registered"], m
        for k in ("n_points", "n_observations"):
            assert abs(g[k] - r[k]) <= 0.02 * r[k], (m, k, g[k], r[k])
        assert abs(g["mean_reproj_px"] - r["mean_reproj_px"]) <= 0.05, m
        assert g["grey_fraction"] < 0.5
    a, b = got["result"]["pose_auc"], ref["result"]["pose_auc"]
    assert a.keys() == b.keys()
    assert abs(a["auc@5"] - b["auc@5"]) <= 0.02, (a, b)
    assert set(run["stage_times"]) == set(chip_smoke.STAGE_KEYS)
    jax_out = str(tmp_path / "jax_out")
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_out))
    # model_refined_0 only: one iteration
    assert chip_smoke.written_files(out) == ["model_refined_1/images.bin"]




R5 = os.path.join(REPO, "weights", "demo_matcher_r5_bf16.msgpack")


@pytest.mark.parametrize("extra,match", [
    (["--matcher-arch", "aspan"], "needs an explicit --matcher-ckpt"),
    (["--matcher-arch", "aspan", "--matcher-ckpt", R5], "does not fit"),
    (["--matcher-arch", "matchformer", "--matcher-ckpt",
      chip_smoke.ASPAN_WEIGHTS], "does not fit"),
    (["--matcher-arch", "efficientloftr"], "needs an explicit --matcher-ckpt"),
    (["--matcher-arch", "efficientloftr", "--matcher-ckpt",
      chip_smoke.ASPAN_WEIGHTS], "does not fit"),
])
def test_verb_refuses_what_is_not_ported(tmp_path, extra, match):
    """As the JAX verb: another family without --matcher-ckpt exits (the
    bundled defaults are LoFTR's); a checkpoint of another family raises
    ValueError from the strict loader. Both before any work; none runs
    LoFTR in the named family's place."""
    scene = tmp_path / "scene"
    chip_smoke.write_scene(str(scene), size=64, n_views=2)
    error = ValueError if "--matcher-ckpt" in extra else SystemExit
    with pytest.raises(error, match=match):
        port_cli.main(["reconstruct", "--scene", str(scene), "--output",
                       str(tmp_path / "out"), "--device", "cpu", *extra])
    assert not (tmp_path / "out").exists()


def test_engine_and_pipeline_configs_refuse_what_is_not_ported():
    from detectorfreesfm_tpu_torch.match.engine import EngineConfig

    # Every family of build_matcher is ported; an unknown name raises.
    for name in ("loftr", "aspan", "matchformer", "efficientloftr"):
        assert EngineConfig(matcher=name).matcher == name
    with pytest.raises(ValueError, match="unknown matcher"):
        EngineConfig(matcher="superglue")
    # --fused on keeps the alt families dense, as in JAX.
    for name, fused in (("aspan", False), ("matchformer", False),
                        ("loftr", True)):
        assert TP.PipelineConfig(matcher=name, fused_matching=True
                                 ).engine_config().fused_matching == fused
    # bf16 compute is ported: the config reaches the matcher's, and a
    # dtype that JAX would run in fp32 raises.
    bf16 = TP.PipelineConfig(compute_dtype="bfloat16").engine_config()
    assert bf16.matcher_config().dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float16"):
        EngineConfig(compute_dtype="float16")
    # known-pose triangulation is ported (tests/test_torch_eval_dataset.py)
    assert TP.PipelineConfig(triangulation_mode=True).triangulation_mode
    cfg = TP.PipelineConfig(match_type="coarse_fine", fused_matching=True)
    assert cfg.engine_config() == EngineConfig(
        round_matches_ratio=4, fused_matching=True, fine_enabled=True)


def test_aspan_verb_with_fused_on_matches_densely(tmp_path, monkeypatch):
    """`--matcher-arch aspan` with the bundled ASpan file and `--fused on`:
    the engine builds ASpan and matches densely (JAX's rule for the other
    families, not a fallback): no kernel wrapper and no fused extraction
    is reached, and the scene's three views register."""
    from detectorfreesfm_tpu_torch.models import loftr
    from detectorfreesfm_tpu_torch.ops import fused_dsm

    def refuse(*a, **k):
        raise AssertionError("the fused path was reached")

    for mod, name in ((fused_dsm, "fused_extract_matches"),
                      (fused_dsm, "dsm_pass1"), (fused_dsm, "dsm_pass2"),
                      (loftr, "fused_extract_matches")):
        monkeypatch.setattr(mod, name, refuse)
    scene = tmp_path / "scene"
    chip_smoke.write_scene(str(scene), size=256, n_views=3)
    got, run = chip_smoke.run_reconstruct(
        port_cli.main, str(scene), str(tmp_path / "out"), "--device", "cpu",
        "--fused", "on", "--img-resize", "176", "--refine-iters", "0",
        "--matcher-arch", "aspan", "--matcher-ckpt",
        chip_smoke.ASPAN_WEIGHTS)
    (_key, engine), = TP._ENGINE_CACHE.items()
    TP._ENGINE_CACHE.clear()
    assert type(engine.model).__name__ == "ASpanMatcher"
    assert not engine.cfg.fused_matching and engine.cfg.matcher == "aspan"
    assert got["result"]["status"] == "ok"
    assert got["result"]["n_registered"] == 3
    assert got["coarse"]["n_points"] > 100


def test_engine_cache_keeps_one_engine_per_arch(tmp_path, monkeypatch):
    """reconstruct_scene keys its engine cache by engine_config(), which
    holds the matcher family: the same weights object under another arch
    builds a new engine, and the same arch reuses it."""
    built = []

    class Engine:
        def __init__(self, cfg, params=None, device=None):
            built.append(cfg.matcher)

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(TP, "PairMatchingEngine", Engine)
    monkeypatch.setattr(TP, "_match_stage", stop)
    scene = tmp_path / "scene"
    chip_smoke.write_scene(str(scene), size=64, n_views=2)
    params = {}
    TP._ENGINE_CACHE.clear()
    for arch in ("loftr", "aspan", "aspan", "matchformer", "loftr"):
        with pytest.raises(Stop):
            TP.reconstruct_scene(str(scene / "images"), str(tmp_path / arch),
                                 TP.PipelineConfig(matcher=arch),
                                 matcher_params=params, device="cpu")
    TP._ENGINE_CACHE.clear()
    assert built == ["loftr", "aspan", "matchformer", "loftr"]


@pytest.mark.parametrize("error,device_error,status,rc", [
    (None, False, "ok", 0),
    ("ValueError('too few tracks')", False, "ok", 0),
    ("RuntimeError('cusolver error: CUSOLVER_STATUS_INVALID_VALUE')", True,
     "refine_failed", 1)])
def test_verb_reports_how_refinement_ended(tmp_path, monkeypatch, error,
                                           device_error, status, rc):
    """The result line says how many refinement iterations completed and
    what stopped them; a fault of the card makes the run fail (exit 1),
    one of the data keeps the last good model, as the JAX verb does."""
    import contextlib
    import io
    import json

    from detectorfreesfm_tpu_torch.sfm.reconstruction import Reconstruction

    def fake_scene(image_dir, output_dir, cfg, info, **kw):
        info.update(refine_iterations_completed=1, refine_error=error,
                    refine_device_error=device_error)
        return Reconstruction()

    monkeypatch.setattr(TP, "reconstruct_scene", fake_scene)
    monkeypatch.setattr(TP, "matches_stored", lambda out: True)
    scene = tmp_path / "scene"
    chip_smoke.write_scene(str(scene), size=64, n_views=2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = port_cli.main(["reconstruct", "--images",
                             str(scene / "images"), "--output",
                             str(tmp_path / "out"), "--device", "cpu",
                             "--refine-iters", "0"])
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert got == rc
    assert result["status"] == status
    assert result["refine_iterations_completed"] == 1
    assert result["refine_error"] == error


def test_verb_needs_cuda_by_default(tmp_path, monkeypatch):
    """--device defaults to cuda, and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = tmp_path / "scene"
    chip_smoke.write_scene(str(scene), size=64, n_views=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["reconstruct", "--scene", str(scene), "--output",
                       str(tmp_path / "out")])
