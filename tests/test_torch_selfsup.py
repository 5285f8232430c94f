"""The port's homography self-supervision against the JAX package on the
CPU: random homographies, warps, cell labels and photometric jitter from
the same keys, and both bootstraps (train_matcher_selfsup,
train_refiner_selfsup) one step at a time from the same parameters.

Tolerances: draws bit-exact (the homography's entries 1e-6 relative after
float32 cos/exp/matmul); warped pixels 1e-4 (the float32 inverse of H
moves samples by ~1e-5 px); cell labels equal; the
photometric noise (erfinv) 1e-5; step-0 losses 1e-5 relative and gradient
norms 1e-4; parameters after a step as Adam's sign-like step allows.
"""

import io
import os
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_torch_train import (CPU, assert_adam_step_close,  # noqa: E402
                              state_of, t2n)

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,h,w", [(0, 64, 64), (1, 416, 416),
                                      (2, 48, 80)])
def test_random_homography_and_warp_equal(seed, h, w):
    from detectorfreesfm_tpu.train import homography as jh
    from detectorfreesfm_tpu_torch.train import homography as th

    key = np.asarray(jax.random.PRNGKey(seed))
    jH = np.asarray(jh.random_homography(jnp.asarray(key), h, w))
    tH = th.random_homography(key, h, w, device=CPU)
    np.testing.assert_allclose(t2n(tH), jH, rtol=1e-6, atol=1e-9)
    img = np.random.default_rng(seed).uniform(0, 1, (h, w)).astype(
        np.float32)
    jw = np.asarray(jh.warp_image(jnp.asarray(img), jnp.asarray(jH)))
    tw = t2n(th.warp_image(torch.tensor(img), torch.tensor(jH)))
    np.testing.assert_allclose(tw, jw, atol=1e-4)
    jg = np.asarray(jh.homography_cell_assignment(jnp.asarray(jH), h, w))
    tg = t2n(th.homography_cell_assignment(torch.tensor(jH), h, w))
    assert tg.dtype == np.int32 and (tg == jg).all()
    assert (jg >= 0).sum() > 0.3 * jg.size


def test_make_selfsup_batch_equal():
    from detectorfreesfm_tpu.train.homography import make_selfsup_batch as jm
    from detectorfreesfm_tpu_torch.train.homography import make_selfsup_batch

    imgs = np.random.default_rng(3).uniform(0, 1, (3, 64, 64)).astype(
        np.float32)
    key = np.asarray(jax.random.PRNGKey(4))
    a = jm(imgs, jnp.asarray(key))
    b = make_selfsup_batch(imgs, key, device=CPU)
    np.testing.assert_allclose(t2n(b["image1"]), np.asarray(a["image1"]),
                               atol=1e-4)
    assert (t2n(b["gt"]) == np.asarray(a["gt"])).all()
    assert (t2n(b["image0"]) == np.asarray(a["image0"])).all()


def test_photometric_equal():
    from detectorfreesfm_tpu.train.selfsup import _photometric
    from detectorfreesfm_tpu_torch.train.selfsup import photometric

    img = np.random.default_rng(5).uniform(0, 1, (64, 64, 1)).astype(
        np.float32)
    key = np.asarray(jax.random.PRNGKey(6))
    a = np.asarray(_photometric(jnp.asarray(key), jnp.asarray(img)))
    b = t2n(photometric(key, torch.tensor(img)))
    np.testing.assert_allclose(b, a, atol=1e-5)


def write_images(root, n=3, size=64, seed=0):
    """A folder of gray PNG images (textured planes of a rendered scene)."""
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          write_scene)

    os.makedirs(root, exist_ok=True)
    write_scene(root, "s", seed, SyntheticConfig(size=size, n_views=n,
                                                 tuple_size=n, n_tuples=1))
    return os.path.join(root, "s", "images")


# --- JAX's step-0 loss and gradient norm, as its bootstraps compute them ----

def jax_matcher_selfsup_step0(image_dir, params, img_size, batch, seed=0,
                              cfg=None):
    """train_matcher_selfsup's first step (selfsup.py's step_fn body, on
    JAX's own functions): (loss, global gradient norm)."""
    from detectorfreesfm_tpu.models.loftr import (DetectorFreeMatcher,
                                                  MatcherConfig)
    from detectorfreesfm_tpu.train.homography import (
        homography_cell_assignment, random_homography, warp_image)
    from detectorfreesfm_tpu.train.losses import coarse_focal_loss
    from detectorfreesfm_tpu.train.selfsup import _photometric
    from detectorfreesfm_tpu_torch.train.selfsup import load_folder

    imgs = jnp.asarray(t2n(load_folder(image_dir, img_size, CPU)))
    model = DetectorFreeMatcher(cfg or MatcherConfig())
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    kb, kh, kp0, kp1 = jax.random.split(key, 4)
    idx = jax.random.randint(kb, (batch,), 0, imgs.shape[0])
    src = jnp.take(imgs, idx, axis=0)
    h = w = img_size
    Hs = jax.vmap(lambda k: random_homography(
        k, h, w, max_rotation=0.35, max_scale=0.25, max_translation=0.15,
        max_perspective=3e-4))(jax.random.split(kh, batch))
    warped = jax.vmap(warp_image)(src, Hs)
    gt = jax.vmap(lambda Hm: homography_cell_assignment(Hm, h, w))(Hs)

    @jax.jit
    def loss_fn(p):
        a = jax.vmap(_photometric)(jax.random.split(kp0, batch),
                                   src[..., None])
        b = jax.vmap(_photometric)(jax.random.split(kp1, batch),
                                   warped[..., None])
        _, conf = model.apply(p, a, b, return_conf=True)
        return coarse_focal_loss(conf, gt)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), float(optax.global_norm(grads))


def jax_refiner_selfsup_step0(image_dir, params, img_size, n_views, n_tracks,
                              seed=0, cfg=None, jitter_px=2.0):
    """train_refiner_selfsup's first step on JAX's own functions."""
    from detectorfreesfm_tpu.models.multiview_matcher import (
        MultiviewRefiner, RefinerConfig)
    from detectorfreesfm_tpu.train.homography import (random_homography,
                                                      warp_image)
    from detectorfreesfm_tpu.train.losses import fine_l2_std_loss
    from detectorfreesfm_tpu_torch.train.selfsup import load_folder

    cfg = cfg or RefinerConfig()
    model = MultiviewRefiner(cfg)
    imgs = jnp.asarray(t2n(load_folder(image_dir, img_size, CPU)))
    v, t, margin = n_views, n_tracks, cfg.crop_size
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    ki, kh, kp, kj, _kr = jax.random.split(key, 5)
    src = imgs[jax.random.randint(ki, (), 0, imgs.shape[0])]
    Hs = jax.vmap(lambda k: random_homography(k, img_size, img_size))(
        jax.random.split(kh, v - 1))
    views = jnp.concatenate(
        [src[None], jax.vmap(warp_image, in_axes=(None, 0))(src, Hs)]
    )[..., None]
    pts = jax.random.uniform(kp, (t, 2), minval=margin,
                             maxval=img_size - margin)
    ph = jnp.concatenate([pts, jnp.ones((t, 1), jnp.float32)], -1)
    dst = jnp.einsum("vij,tj->vti", Hs, ph)
    z = jnp.where(jnp.abs(dst[..., 2:]) < 1e-6, 1e-6, dst[..., 2:])
    q_gt = jnp.clip(dst[..., :2] / z, -4.0 * img_size, 4.0 * img_size)
    gt = jnp.concatenate([pts[None], q_gt]).transpose(1, 0, 2)
    in_frame = ((gt[..., 0] >= margin) & (gt[..., 0] < img_size - margin)
                & (gt[..., 1] >= margin) & (gt[..., 1] < img_size - margin))
    mask = in_frame.at[:, 0].set(True)
    jit_q = jax.random.uniform(kj, (t, v, 2), minval=-jitter_px,
                               maxval=jitter_px).at[:, 0].set(0.0)
    node_xy = (gt + jit_q).astype(jnp.float32)
    node_img = jnp.broadcast_to(jnp.arange(v, dtype=jnp.int32)[None], (t, v))

    @jax.jit
    def loss_fn(p):
        out = model.apply(p, views, node_img, node_xy,
                          jnp.ones((t, v), jnp.float32), mask)
        return fine_l2_std_loss(out.coords[:, 1:], gt[:, 1:], out.std[:, 1:],
                                mask[:, 1:])

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), float(optax.global_norm(grads))


def printed_losses(text):
    return [float(x) for x in re.findall(r"loss (\S+) \(", text)]


def test_matcher_selfsup_equals_jax(tmp_path):
    """Two steps of both bootstraps from the same parameters (JAX's init;
    fine head left out, as JAX's template has none): the step-0 loss and
    gradient norm, the printed losses, and the parameters written."""
    from detectorfreesfm_tpu.models.loftr import (DetectorFreeMatcher,
                                                  MatcherConfig as JC)
    from detectorfreesfm_tpu.train.selfsup import (load_matcher_params,
                                                   train_matcher_selfsup as jt)
    from detectorfreesfm_tpu_torch.models.loftr import MatcherConfig
    from detectorfreesfm_tpu_torch.train.selfsup import train_matcher_selfsup

    images = write_images(str(tmp_path / "im"))
    jcfg = JC(n_coarse_layers=1, border=1, max_matches=32)
    x = jnp.zeros((1, 64, 64, 1))
    params = jax.jit(DetectorFreeMatcher(jcfg).init)(jax.random.PRNGKey(1),
                                                     x, x)
    loss0, norm0 = jax_matcher_selfsup_step0(images, params, 64, 2, cfg=jcfg)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jt(images, str(tmp_path / "j.msgpack"), steps=2, img_size=64,
           batch=2, log_every=1, init_params=params, matcher_cfg=jcfg)
    log = str(tmp_path / "log.jsonl")
    out = str(tmp_path / "t.msgpack")
    buf2 = io.StringIO()
    with redirect_stdout(buf2):
        got = train_matcher_selfsup(
            images, out, steps=2, img_size=64, batch=2, log_every=1,
            init_params=state_of(params), device=CPU, log_json=log,
            matcher_cfg=MatcherConfig(n_coarse_layers=1, border=1,
                                      max_matches=32))
    import json

    with open(log) as f:
        steps = [json.loads(ln) for ln in f]
    np.testing.assert_allclose(steps[0]["loss"], loss0, rtol=1e-5)
    np.testing.assert_allclose(steps[0]["grad_norm"], norm0, rtol=1e-4)
    np.testing.assert_allclose(printed_losses(buf2.getvalue()),
                               printed_losses(buf.getvalue()), atol=2e-4)
    back = load_matcher_params(out, img_size=64, cfg=jcfg)
    jp = load_matcher_params(str(tmp_path / "j.msgpack"), img_size=64,
                             cfg=jcfg)
    assert set(got) == set(state_of(jp))
    assert_adam_step_close(state_of(back), state_of(jp), 1e-3, frac=0.02)


def test_refiner_selfsup_equals_jax(tmp_path):
    from detectorfreesfm_tpu.models.multiview_matcher import (
        MultiviewRefiner, RefinerConfig as JRC)
    from detectorfreesfm_tpu.train.refiner_selfsup import (
        load_refiner_params, train_refiner_selfsup as jt)
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        RefinerConfig)
    from detectorfreesfm_tpu_torch.train.refiner_selfsup import (
        train_refiner_selfsup)

    images = write_images(str(tmp_path / "im"), size=96)
    jcfg = JRC(crop_size=11, window=7, n_layers=1)
    v, t = 3, 16
    params = jax.jit(MultiviewRefiner(jcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((v, 96, 96, 1)),
        jnp.zeros((t, v), jnp.int32), jnp.zeros((t, v, 2)),
        jnp.ones((t, v)), jnp.zeros((t, v), bool))
    loss0, norm0 = jax_refiner_selfsup_step0(images, params, 96, v, t,
                                             cfg=jcfg)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jt(images, str(tmp_path / "j.msgpack"), steps=2, img_size=96,
           n_views=v, n_tracks=t, log_every=1, refiner_cfg=jcfg,
           init_params=params)
    log = str(tmp_path / "log.jsonl")
    out = str(tmp_path / "t.msgpack")
    buf2 = io.StringIO()
    with redirect_stdout(buf2):
        train_refiner_selfsup(
            images, out, steps=2, img_size=96, n_views=v, n_tracks=t,
            log_every=1, refiner_cfg=RefinerConfig(crop_size=11, window=7,
                                                   n_layers=1),
            init_params=state_of(params), device=CPU, log_json=log)
    import json

    with open(log) as f:
        steps = [json.loads(ln) for ln in f]
    np.testing.assert_allclose(steps[0]["loss"], loss0, rtol=1e-5)
    np.testing.assert_allclose(steps[0]["grad_norm"], norm0, rtol=1e-4)
    np.testing.assert_allclose(printed_losses(buf2.getvalue()),
                               printed_losses(buf.getvalue()), atol=2e-4)
    back = load_refiner_params(out, cfg=jcfg)
    jp = load_refiner_params(str(tmp_path / "j.msgpack"), cfg=jcfg)
    assert_adam_step_close(state_of(back), state_of(jp), 1e-3, frac=0.02)


def test_selfsup_verbs_write_what_jax_reads(tmp_path):
    """Both bootstrap verbs on the CPU at a small size: checkpoints that
    JAX's loaders read, finite logged losses, and bf16 refused."""
    from detectorfreesfm_tpu_torch import cli

    images = write_images(str(tmp_path / "im"), size=64)
    m = str(tmp_path / "m.msgpack")
    assert cli.main(["train-matcher-selfsup", "--images", images, "--output",
                     m, "--steps", "1", "--img-resize", "64",
                     "--batch-size", "1", "--device", "cpu"]) == 0
    r = str(tmp_path / "r.msgpack")
    log = str(tmp_path / "r.jsonl")
    assert cli.main(["train-refiner-selfsup", "--images", images,
                     "--output", r, "--steps", "2", "--img-resize", "64",
                     "--n-views", "3", "--n-tracks", "8", "--device", "cpu",
                     "--log-json", log]) == 0
    from flax import serialization

    for path in (m, r):
        with open(path, "rb") as f:
            raw = serialization.msgpack_restore(f.read())
        assert set(raw) == {"params"}
    with open(m, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    assert "fine_match" not in raw["params"]["params"]
    assert set(raw["params"]) == {"params", "batch_stats"}
    with open(log) as f:
        assert len(f.read().splitlines()) == 2
    with pytest.raises(SystemExit, match="item 12"):
        cli.main(["train-matcher-selfsup", "--images", images, "--output", m,
                  "--dtype-train", "bfloat16", "--device", "cpu"])
