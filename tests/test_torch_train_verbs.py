"""The port's `train` verb and refiner checkpoints against the JAX
package on the CPU (the rest of the refiner side is in
test_torch_train.py, whose helpers these tests use)."""

import json

import jax
import numpy as np
import pytest
import torch

from test_torch_train import (_refiner_setup, jax_init_state,
                              assert_leaves_close, planar_tuple, state_of,
                              t2n, write_planar_scenes)
from detectorfreesfm_tpu_torch.utils import checkpoint

torch.set_num_threads(1)


def test_trainer_checkpoints_both_ways(tmp_path):
    """The port's checkpoint loads through JAX's Trainer.load_params and
    load_refiner_params, and JAX's through the port's; a bootstrap-style
    {params} file warm-starts too."""
    from detectorfreesfm_tpu.train.refiner_selfsup import (
        load_refiner_params as jlr)

    jt, tt, batch = _refiner_setup()
    jstate = jax_init_state(jt, batch)
    tstate = tt.init_state(batch)
    tstate = tstate._replace(params=state_of(jstate.params), step=1)
    path = str(tmp_path / "port.msgpack")
    tt.save_checkpoint(tstate, path)

    back = jt.load_params(path, jstate.params)
    assert_leaves_close(state_of(back), tstate.params, 0.0)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jstate.params)
    from detectorfreesfm_tpu.models.multiview_matcher import RefinerConfig

    via = jlr(path, cfg=RefinerConfig(crop_size=11, window=7, n_layers=1))
    assert_leaves_close(state_of(via), tstate.params, 0.0)
    from flax import serialization

    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    assert raw["step"] == 1 and set(raw) == {"params", "step"}

    jpath = str(tmp_path / "jax.msgpack")
    jt.save_checkpoint(jstate, jpath)
    got = tt.load_params(jpath, tstate.params)
    assert_leaves_close(got, state_of(jstate.params), 0.0)
    boot = str(tmp_path / "boot.msgpack")
    checkpoint.save_checkpoint(
        boot, checkpoint.state_dict_to_flax_variables(tstate.params))
    assert_leaves_close(tt.load_params(boot, tstate.params), tstate.params,
                        0.0)
    del got["transformer.layer_0_self.q_proj.weight"]
    with pytest.raises(ValueError):
        tt.load_params(jpath, got)


def test_train_verb_equals_jax_verb(tmp_path):
    """Both packages' `train` verbs on the same files from the same fp32
    warm start: the written checkpoints agree to Adam's sign-like steps,
    and the loss log agrees."""
    from detectorfreesfm_tpu import cli as jcli
    from detectorfreesfm_tpu.models.multiview_matcher import RefinerConfig
    from detectorfreesfm_tpu.train.trainer import TrainConfig as JTC
    from detectorfreesfm_tpu.train.trainer import Trainer as JT
    from detectorfreesfm_tpu_torch import cli

    data = str(tmp_path / "scenes")
    write_planar_scenes(data)
    jt = JT(JTC(refiner=RefinerConfig(crop_size=11, window=7), n_tracks=16))
    tup = planar_tuple(v=3, size=48)
    jstate = jax_init_state(jt, {k: tup[k][None] for k in tup})
    init = str(tmp_path / "init.msgpack")
    jt.save_checkpoint(jstate, init)
    args = ["train", "--data", data, "--epochs", "1", "--batch-size", "2",
            "--img-resize", "48", "--samples-per-scene", "2",
            "--log-every", "1", "--n-tracks", "16", "--window", "7",
            "--init-ckpt", init]
    assert jcli.main(args + ["--output", str(tmp_path / "jax")]) == 0
    log = str(tmp_path / "log.jsonl")
    assert cli.main(args + ["--output", str(tmp_path / "port"),
                            "--device", "cpu", "--log-json", log]) == 0
    ja = jt.load_params(str(tmp_path / "jax" / "ckpt_ep0.msgpack"),
                        jstate.params)
    got = checkpoint.flax_variables_to_state_dict(checkpoint.read_variables(
        str(tmp_path / "port" / "ckpt_ep0.msgpack")))
    # Two steps, from labels that differ at the reference inputs' ties.
    lr = 2e-4 * 2 / 4
    want = state_of(ja)
    for k in want:
        assert np.abs(t2n(got[k]) - t2n(want[k])).max() <= 4 * lr * 1.01, k
    with open(log) as f:
        steps = [json.loads(ln) for ln in f]
    assert [s["step"] for s in steps] == [0, 1]
    assert all(np.isfinite(s["loss"]) and s["grad_norm"] > 0 for s in steps)


def test_scene_writers_equal_jax(tmp_path):
    """write_scene and write_scene_eval_layout (PNG through data/png.py)
    against the JAX package's PIL writers from the same seed: the decoded
    pixels, depths, index arrays and tuples, and the pose and intrinsics
    files, are equal."""
    from PIL import Image

    from detectorfreesfm_tpu.data import synthetic as js
    from detectorfreesfm_tpu_torch.data import synthetic as ts

    jcfg = js.SyntheticConfig(size=64, n_views=3, tuple_size=2, n_tuples=4)
    tcfg = ts.SyntheticConfig(size=64, n_views=3, tuple_size=2, n_tuples=4)
    a = js.write_scene(str(tmp_path / "j"), "s", 7, jcfg)
    b = ts.write_scene(str(tmp_path / "t"), "s", 7, tcfg)
    za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert set(za.files) == set(zb.files)
    for k in za.files:
        assert (za[k] == zb[k]).all(), k
    for rel in za["image_paths"]:
        pa = np.asarray(Image.open(tmp_path / "j" / rel))
        pb = np.asarray(Image.open(tmp_path / "t" / rel))
        assert (pa == pb).all(), rel
    for rel in za["depth_paths"]:
        assert (np.load(tmp_path / "j" / rel) == np.load(
            tmp_path / "t" / rel)).all(), rel
    js.write_scene_eval_layout(str(tmp_path / "je"), 7, jcfg)
    ts.write_scene_eval_layout(str(tmp_path / "te"), 7, tcfg)
    for sub, name in (("images", "view_001.png"), ("poses", "view_002.txt"),
                      ("intrins", "view_000.txt")):
        fa, fb = tmp_path / "je" / sub / name, tmp_path / "te" / sub / name
        if sub == "images":
            assert (np.asarray(Image.open(fa)) == np.asarray(
                Image.open(fb))).all()
        else:
            assert fa.read_text() == fb.read_text()


def test_epipolar_pose_eval_equals_jax():
    from detectorfreesfm_tpu.train.trainer import epipolar_pose_eval as je
    from detectorfreesfm_tpu_torch.train.trainer import epipolar_pose_eval

    rng = np.random.default_rng(0)
    c, g = rng.normal(0, 3, (20, 3, 2)), rng.normal(0, 3, (20, 3, 2))
    m = rng.uniform(size=(20, 3)) > 0.4
    assert epipolar_pose_eval(c, g, m) == je(c, g, m)
    out = epipolar_pose_eval(c, g, np.zeros_like(m))
    assert np.isnan(out["mean_px"]) and np.isnan(out["median_px"])
