"""The port's training slice, refiner side, against the JAX package on the
CPU: the JAX draws (utils/prng.py), optax's schedules and chain
(train/optimizers.py), the losses, depth-warp supervision, one Trainer
step, checkpoints both ways and the `train` verb.

Tolerances: draws bit-exact (normal: 1e-4 absolute, erfinv); labels
equal (but for the reference inputs' rounding ties, see
train/supervision.py); losses 1e-5 relative; the global gradient norm
1e-4; each leaf's gradient within 5e-3 of the leaf's largest value
(measured against a float64 run of the port, JAX's float32 gradients of
the refiner's conv stack sit up to 4e-4 away, and one ReLU input of
~1e-7 whose sign float32 noise flips moves a transformer leaf by 2.4e-3);
parameters after one step within 1e-3 of lr (Adam's first step moves
each leaf by about lr whatever the gradient's size).

    JAX_PLATFORMS=cpu python tests/test_torch_train.py --record

records JAX_TRAIN, the JAX numbers that chip_smoke.py's `train` phase
holds the port to (see `record`); with `--dtype bfloat16` appended,
JAX_TRAIN_BF16 for its `bf16` phase.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from detectorfreesfm_tpu_torch.utils import checkpoint, prng  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
REFINER_W = os.path.join(REPO, "weights", "demo_refiner_r4_bf16.msgpack")


def t2n(x):
    return x.detach().cpu().numpy()


def to_torch(tree):
    """A JAX/numpy pytree of dicts -> the same tree of torch tensors."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def state_of(variables):
    """JAX variables (or a gradient tree) -> the port's fp32 state_dict."""
    return checkpoint.flax_variables_to_state_dict(to_torch(variables))


def assert_leaves_close(got, want, rtol, names=None):
    names = names or sorted(want)
    assert set(got) == set(want)
    for k in names:
        a, b = t2n(got[k]), t2n(want[k])
        scale = max(np.abs(b).max(), 1e-30)
        err = np.abs(a - b).max() / scale
        assert err <= rtol, (k, err)


def assert_adam_step_close(got, want, lr, frac=0.01):
    """Parameters after Adam steps from the same start: Adam moves each
    element by about lr whatever its gradient's size, so an element whose
    tiny gradient has the other sign moves the other way. At most `frac`
    of the elements differ by more than 1e-3 lr, and none by more than
    2 lr per step taken (JAX's first step is one)."""
    n_bad = n = 0
    for k in want:
        d = np.abs(t2n(got[k]) - t2n(want[k]))
        assert d.max() <= 2.0 * lr * 1.01, (k, d.max())
        n_bad += int((d > 1e-3 * lr).sum())
        n += d.size
    assert n_bad <= frac * n, (n_bad, n)


def planar_tuple(v=3, size=64, f=80.0, seed=0):
    from test_training import _planar_tuple

    return _planar_tuple(v=v, size=size, f=f, seed=seed)


# --- draws ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 66, 12345])
def test_keys_split_fold_in_bit_exact(seed):
    k = jax.random.PRNGKey(seed)
    assert (np.asarray(k) == prng.PRNGKey(seed)).all()
    for n in (2, 5, 7):
        assert (np.asarray(jax.random.split(k, n))
                == prng.split(prng.PRNGKey(seed), n)).all()
    for d in (0, 1, 3, 2 ** 31 + 5):
        assert (np.asarray(jax.random.fold_in(k, d))
                == prng.fold_in(prng.PRNGKey(seed), d)).all()


@pytest.mark.parametrize("shape,lo,hi", [
    ((), 0.0, 1.0), ((5, 7), -2.0, 2.0), ((1000,), -0.35, 0.35),
    ((2, 3), -3e-4, 3e-4), ((256, 2), 19.0, 237.0), ((77,), -0.2, 0.2)])
def test_uniform_bit_exact(shape, lo, hi):
    key = np.asarray(jax.random.split(jax.random.PRNGKey(3), 4))[2]
    a = np.asarray(jax.random.uniform(jnp.asarray(key), shape, minval=lo,
                                      maxval=hi))
    b = t2n(prng.uniform(key, shape, lo, hi, device=CPU))
    assert a.shape == b.shape
    assert (a.view(np.uint32) == b.view(np.uint32)).all()


@pytest.mark.parametrize("shape,lo,hi", [
    ((4,), 0, 7), ((100,), 0, 12), ((), 0, 5), ((50,), 3, 1000003),
    ((9,), 5, 5)])
def test_randint_bit_exact(shape, lo, hi):
    key = np.asarray(jax.random.PRNGKey(11))
    a = np.asarray(jax.random.randint(jnp.asarray(key), shape, lo, hi))
    b = t2n(prng.randint(key, shape, lo, hi, device=CPU))
    assert a.dtype == b.dtype and (a == b).all()


def test_normal_close():
    key = np.asarray(jax.random.PRNGKey(5))
    a = np.asarray(jax.random.normal(jnp.asarray(key), (64, 64, 1)))
    b = t2n(prng.normal(key, (64, 64, 1), device=CPU))
    np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)


# --- optimizer --------------------------------------------------------------

SCHEDULES = [
    dict(scheduler="multistep", milestones=(1, 2), steps_per_epoch=4),
    dict(scheduler="multistep", milestones=(1, 2), steps_per_epoch=4,
         warmup_steps=3),
    dict(scheduler="cosine", total_steps=9, steps_per_epoch=4),
    dict(scheduler="exponential", gamma=0.5, steps_per_epoch=4),
    dict(scheduler="exponential", gamma=0.5, steps_per_epoch=4,
         warmup_steps=2),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw["scheduler"]
                         + ("_warm" if "warmup_steps" in kw else ""))
def test_schedules_equal_optax(kw):
    from detectorfreesfm_tpu.train import optimizers as jo
    from detectorfreesfm_tpu_torch.train import optimizers as to

    js = jo.build_schedule(jo.OptimConfig(**kw))
    ts = to.build_schedule(to.OptimConfig(**kw))
    for c in range(0, 3 * kw["steps_per_epoch"] + 2):
        a = np.float32(js(jnp.int32(c)))
        b = np.float32(ts(c))
        assert abs(a - b) <= 1e-6 * abs(a) + 1e-12, (c, a, b)


def _toy_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "params": {"backbone": {"conv": {"kernel": rng.normal(
            0, 1, (3, 3, 2, 4)).astype(np.float32)}},
            "head": {"dense": {"kernel": rng.normal(0, 1, (4, 5)).astype(
                np.float32), "bias": rng.normal(0, 1, 5).astype(np.float32)},
                "norm": {"scale": rng.normal(1, 0.1, 4).astype(np.float32)}}},
        "batch_stats": {"backbone": {"bn": {
            "mean": rng.normal(0, 1, 4).astype(np.float32),
            "var": rng.uniform(0.5, 2, 4).astype(np.float32)}}},
    }


@pytest.mark.parametrize("gscale,wd,kind", [
    (0.01, 0.0, "build"), (10.0, 0.0, "build"), (10.0, 1e-2, "build"),
    (10.0, 1e-8, "adamw"), (0.01, 1e-4, "adamw")])
def test_optimizer_equals_optax_chain(gscale, wd, kind):
    """Three updates of the whole chain (clip below and above the norm,
    backbone labels, decoupled decay of every leaf, BN statistics
    included)."""
    import optax

    from detectorfreesfm_tpu.train import optimizers as jo
    from detectorfreesfm_tpu_torch.train import optimizers as to

    params = _toy_tree(0)
    kw = dict(canonical_lr=1e-2, weight_decay=wd, scheduler="multistep",
              milestones=(1,), steps_per_epoch=2)
    if kind == "build":
        tx = jo.build_optimizer(jo.OptimConfig(**kw), params)
    else:
        tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(
            optax.cosine_decay_schedule(1e-2, 5), weight_decay=wd))
    jstate = tx.init(params)
    tparams = state_of(params)
    if kind == "build":
        opt = to.build_optimizer(to.OptimConfig(**kw), tparams)
    else:
        opt = to.adamw(tparams, 1e-2, 5, weight_decay=wd)
    assert opt.ratios["backbone.conv.weight"] == (
        0.5 if kind == "build" else 1.0)
    for i in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: x * gscale, _toy_tree(10 + i))
        upd, jstate = tx.update(grads, jstate, params)
        params = optax.apply_updates(params, upd)
        norm = opt.step(tparams, state_of(grads))
        want = float(optax.global_norm(grads))
        assert abs(norm - want) <= 1e-6 * want
        assert_leaves_close(tparams, state_of(params), 1e-6)


# --- losses -----------------------------------------------------------------

@pytest.mark.parametrize("with_valid", [False, True])
def test_coarse_focal_loss_and_grad(with_valid):
    from detectorfreesfm_tpu.train.losses import coarse_focal_loss as jl
    from detectorfreesfm_tpu_torch.train.losses import coarse_focal_loss as tl

    rng = np.random.default_rng(1)
    b, l, s = 2, 30, 24
    conf = rng.uniform(0, 1, (b, l, s)).astype(np.float32) ** 4
    conf[0, 3] = 0.0
    gt = rng.integers(-1, s, (b, l)).astype(np.int32)
    valid = rng.uniform(size=(b, l)) > 0.2 if with_valid else None
    jv = None if valid is None else jnp.asarray(valid)
    a, ga = jax.value_and_grad(lambda c: jl(c, jnp.asarray(gt), jv))(
        jnp.asarray(conf))
    ct = torch.tensor(conf, requires_grad=True)
    got = tl(ct, torch.tensor(gt), None if valid is None
             else torch.tensor(valid))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(a), rtol=1e-5)
    np.testing.assert_allclose(t2n(ct.grad), np.asarray(ga), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ga)).max())


def test_fine_l2_std_loss_and_grad():
    from detectorfreesfm_tpu.train.losses import fine_l2_std_loss as jl
    from detectorfreesfm_tpu_torch.train.losses import fine_l2_std_loss as tl

    rng = np.random.default_rng(2)
    pred = rng.normal(0, 3, (40, 3, 2)).astype(np.float32)
    gt = rng.normal(0, 3, (40, 3, 2)).astype(np.float32)
    gt[5, 1] = np.inf                       # out-of-frame target, masked
    std = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    mask = rng.uniform(size=(40, 3)) > 0.3
    mask[5, 1] = False
    f = lambda p, s: jl(p, jnp.asarray(gt), s, jnp.asarray(mask))
    a, (gp, gs) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(std))
    pt = torch.tensor(pred, requires_grad=True)
    st = torch.tensor(std, requires_grad=True)
    got = tl(pt, torch.tensor(gt), st, torch.tensor(mask))
    got.backward()
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(a), rtol=1e-6)
    np.testing.assert_allclose(t2n(pt.grad), np.asarray(gp), rtol=1e-5,
                               atol=1e-7)
    # The std weight is detached: no gradient reaches std on either side.
    assert st.grad is None and float(jnp.abs(gs).max()) == 0.0


# --- supervision ------------------------------------------------------------

def _jax_tracks(tup, key, **kw):
    from detectorfreesfm_tpu.train.supervision import generate_tracks

    return generate_tracks(
        jnp.asarray(tup["depths"]), jnp.asarray(tup["K"]),
        jnp.asarray(tup["qvec"]), jnp.asarray(tup["tvec"]),
        jnp.asarray(key), **kw)


def _port_tracks(tup, key, **kw):
    from detectorfreesfm_tpu_torch.train.supervision import generate_tracks

    return generate_tracks(*(torch.tensor(tup[k]) for k in (
        "depths", "K", "qvec", "tvec")), key, **kw)


def _assert_tracks_equal(a, b, atol=1e-4):
    """Equal labels, but for the reference inputs on a rounding tie: the
    port rounds the exact grid point (half to even) and JAX its float32
    noise, so those differ by one grid step (8 px) exactly."""
    for name in ("node_img", "node_mask", "track_valid"):
        assert (np.asarray(getattr(a, name)) == t2n(getattr(b, name))).all(), \
            name
    for name in ("gt_xy", "node_scale"):
        x, y = np.asarray(getattr(a, name)), t2n(getattr(b, name))
        np.testing.assert_allclose(y, x, atol=atol, rtol=1e-5, err_msg=name)
    x, y = np.asarray(a.node_xy), t2n(b.node_xy)
    np.testing.assert_allclose(y[:, 1:], x[:, 1:], atol=atol, rtol=1e-5)
    d = np.abs(y[:, 0] - x[:, 0])
    assert ((d < atol) | (np.abs(d - 8.0) < atol)).all()
    gt0 = t2n(b.gt_xy)[:, 0]
    on_tie = np.abs(gt0 / 8.0 - np.floor(gt0 / 8.0) - 0.5) < 1e-6
    assert not (np.abs(d - 8.0) < atol)[~on_tie].any()
    return int((d > atol).sum())


@pytest.mark.parametrize("seed,n_tracks,v", [(0, 64, 3), (1, 200, 4),
                                             (2, 16, 2)])
def test_generate_tracks_equal(seed, n_tracks, v):
    """Planar tuples (few eligible candidates at 200: the top-k pads with
    ties at -1, broken toward the lower index)."""
    tup = planar_tuple(v=v, seed=seed)
    key = np.asarray(jax.random.PRNGKey(seed + 3))
    _assert_tracks_equal(_jax_tracks(tup, key, n_tracks=n_tracks),
                         _port_tracks(tup, key, n_tracks=n_tracks))


def test_generate_tracks_rendered_scene():
    """A rendered multi-plane scene: plane edges put depth samples on the
    thresholds, so the visibility masks agree to 99.9%, and the chosen
    tracks agree wherever their labels do."""
    from detectorfreesfm_tpu_torch.data.synthetic import (
        SyntheticConfig, generate_scene)

    imgs, depths, K, q, t = generate_scene(4, SyntheticConfig(
        size=128, n_views=4))
    tup = {"depths": depths, "K": K.astype(np.float32),
           "qvec": q.astype(np.float32), "tvec": t.astype(np.float32)}
    key = np.asarray(jax.random.PRNGKey(9))
    a = _jax_tracks(tup, key, n_tracks=100)
    b = _port_tracks(tup, key, n_tracks=100)
    agree = np.mean(np.asarray(a.node_mask) == t2n(b.node_mask))
    assert agree >= 0.999, agree
    if agree == 1.0:
        _assert_tracks_equal(a, b)


# --- the trainer ------------------------------------------------------------

def _refiner_setup(n_tracks=32, seed=0):
    from detectorfreesfm_tpu.models.multiview_matcher import (
        RefinerConfig as JRC)
    from detectorfreesfm_tpu.train.optimizers import OptimConfig as JOC
    from detectorfreesfm_tpu.train.trainer import TrainConfig as JTC
    from detectorfreesfm_tpu.train.trainer import Trainer as JT
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        RefinerConfig)
    from detectorfreesfm_tpu_torch.train.optimizers import OptimConfig
    from detectorfreesfm_tpu_torch.train.trainer import TrainConfig, Trainer

    okw = dict(canonical_lr=2e-3, true_batch_size=2, milestones=(1000,))
    jt = JT(JTC(refiner=JRC(crop_size=11, window=7, n_layers=1),
                optim=JOC(**okw), n_tracks=n_tracks))
    tt = Trainer(TrainConfig(refiner=RefinerConfig(crop_size=11, window=7,
                                                   n_layers=1),
                             optim=OptimConfig(**okw), n_tracks=n_tracks),
                 device=CPU)
    batch = {k: np.stack([planar_tuple(seed=seed)[k],
                          planar_tuple(seed=seed + 1)[k]])
             for k in ("images", "depths", "K", "qvec", "tvec")}
    return jt, tt, batch


def jax_init_state(jt, batch):
    """JAX's Trainer.init_state with its model.init jitted (eager init
    takes ~20 s on the CPU): the same params, optimizer and state."""
    from detectorfreesfm_tpu.train.optimizers import build_optimizer
    from detectorfreesfm_tpu.train.trainer import TrainState

    images = jnp.asarray(batch["images"][0])
    v, t = images.shape[0], jt.cfg.n_tracks
    params = jax.jit(jt.model.init)(
        jax.random.PRNGKey(jt.cfg.seed), images, jnp.zeros((t, v), jnp.int32),
        jnp.zeros((t, v, 2), jnp.float32), jnp.ones((t, v), jnp.float32),
        jnp.zeros((t, v), bool))
    jt.tx = build_optimizer(jt.cfg.optim, params)
    return TrainState(params, jt.tx.init(params), jnp.zeros((), jnp.int32))


def port_labels(tt, batch, rng):
    """The port's labels of a batch as JAX's batched SupervisionBatch."""
    from detectorfreesfm_tpu.train.supervision import SupervisionBatch

    spvs = tt.supervise(batch, np.asarray(rng))
    return SupervisionBatch(*(np.stack([t2n(getattr(s, f)) for s in spvs])
                              for f in SupervisionBatch._fields))


def _jax_refiner_value_and_grad(jt, params, batch, spv):
    images = jnp.asarray(batch["images"])

    def loss_fn(p):
        losses = jax.vmap(lambda im, s: jt._loss_one(p, im, s))(
            images, jax.tree_util.tree_map(jnp.asarray, spv))
        return jnp.mean(losses)

    return jax.value_and_grad(loss_fn)(params)


def test_trainer_step_equals_jax():
    """The same params (JAX's init through the converter), batch, key and
    labels (the port's, fed to JAX's jitted step: the reference inputs'
    rounding ties aside they are JAX's, test_generate_tracks_equal): loss
    and every leaf's gradient; then one step through both trainers."""
    jt, tt, batch = _refiner_setup()
    jstate = jax_init_state(jt, batch)
    rng = jax.random.fold_in(jax.random.PRNGKey(jt.cfg.seed), 0)
    tstate = tt.init_state(batch)
    tstate = tstate._replace(params=state_of(jstate.params))
    assert set(tstate.params) == set(tt.init_state().params)
    spv = port_labels(tt, batch, rng)

    jl, jg = _jax_refiner_value_and_grad(jt, jstate.params, batch, spv)
    tl, tg = tt.loss_and_grads(tstate.params, batch, np.asarray(rng))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_leaves_close(tg, state_of(jg), 5e-3)
    norm = lambda g: float(torch.sqrt(sum(torch.sum(v * v)
                                          for v in g.values())))
    np.testing.assert_allclose(norm(tg), norm(state_of(jg)), rtol=1e-4)

    # JAX's step is its optax chain on these gradients (its jitted step
    # would only compile the same program again).
    upd, _ = jt.tx.update(jg, jstate.opt_state, jstate.params)
    jparams2 = optax.apply_updates(jstate.params, upd)
    tstate2, tloss = tt.train_step(tstate, batch, np.asarray(rng))
    np.testing.assert_allclose(float(tloss), float(jl), rtol=1e-5)
    assert tstate2.step == 1 and tt.history[0]["loss"] == float(tloss)
    np.testing.assert_allclose(tt.history[0]["grad_norm"], norm(
        state_of(jg)), rtol=1e-4)
    assert_adam_step_close(tstate2.params, state_of(jparams2), 2e-3 * 2 / 4)


def test_warm_start_dtype_jax_bf16_port_fp32():
    """JAX's Trainer.load_params keeps the bundled refiner's bf16 leaves
    (a fault of the JAX package); the port's casts to fp32, as every other
    loader of both packages does."""
    from detectorfreesfm_tpu.train.trainer import Trainer as JT
    from detectorfreesfm_tpu_torch.train.trainer import Trainer

    jt = JT()
    tup = planar_tuple(v=3, size=64)
    jstate = jax_init_state(jt, {k: tup[k][None] for k in tup})
    jp = jt.load_params(REFINER_W, jstate.params)
    jdt = {str(x.dtype) for x in jax.tree_util.tree_leaves(jp)}
    tt = Trainer(device=CPU)
    tp = tt.load_params(REFINER_W, tt.init_state().params)
    assert jdt == {"bfloat16"}
    assert {v.dtype for v in tp.values()} == {torch.float32}
    assert_leaves_close(tp, state_of(jp), 0.0)


@pytest.mark.parametrize("which", ["refiner"])
def test_fresh_init_matches_flax_distribution(which):
    """The port's flax-style init against flax's own: per-leaf std within
    10% (leaves of at least 256 values), and the constant leaves equal."""
    from detectorfreesfm_tpu_torch.train import trainer as tr

    if which == "refiner":
        from detectorfreesfm_tpu.models.multiview_matcher import (
            MultiviewRefiner as JM, RefinerConfig as JC)
        from detectorfreesfm_tpu_torch.models.multiview_matcher import (
            MultiviewRefiner, RefinerConfig)

        v, t = 3, 8
        jv = jax.jit(JM(JC()).init)(jax.random.PRNGKey(0),
                                    jnp.zeros((v, 64, 64, 1)),
                           jnp.zeros((t, v), jnp.int32),
                           jnp.zeros((t, v, 2)), jnp.ones((t, v)),
                           jnp.zeros((t, v), bool))
        port = tr.init_leaves(MultiviewRefiner(RefinerConfig()), 12345, CPU)
    else:
        from detectorfreesfm_tpu.models.loftr import DetectorFreeMatcher as JM
        from detectorfreesfm_tpu.models.loftr import MatcherConfig as JC
        from detectorfreesfm_tpu_torch.models.loftr import (
            DetectorFreeMatcher, MatcherConfig)

        x = jnp.zeros((1, 64, 64, 1))
        jv = JM(JC(fine_enabled=True)).init(jax.random.PRNGKey(0), x, x)
        port = tr.init_leaves(DetectorFreeMatcher(MatcherConfig(
            fine_enabled=True)), 66, CPU)
    want = state_of(jv)
    assert set(port) == set(want)
    for k, w in want.items():
        a, b = t2n(port[k]), t2n(w)
        if b.std() == 0:
            assert (a == b).all(), k
        elif b.size >= 256:
            assert abs(a.std() / b.std() - 1) < 0.1, (k, a.std(), b.std())


# --- the verb ---------------------------------------------------------------

def write_planar_scenes(root, size=48, views=3):
    """Two scenes of planar tuples in the trainers' index layout (PNG with
    JAX's 8-bit truncation)."""
    from detectorfreesfm_tpu_torch.data.png import write_png

    os.makedirs(root, exist_ok=True)
    for s in range(2):
        tup = planar_tuple(v=views, size=size, seed=s)
        ips, dps = [], []
        for vi in range(views):
            ip, dp = f"s{s}_im{vi}.png", f"s{s}_d{vi}.npy"
            write_png(os.path.join(root, ip),
                      (tup["images"][vi, :, :, 0] * 255).astype(np.uint8))
            np.save(os.path.join(root, dp), tup["depths"][vi])
            ips.append(ip)
            dps.append(dp)
        np.savez(os.path.join(root, f"scene{s}.npz"),
                 image_paths=np.array(ips), depth_paths=np.array(dps),
                 K=tup["K"].astype(np.float64),
                 qvec=tup["qvec"].astype(np.float64),
                 tvec=tup["tvec"].astype(np.float64),
                 tuples=np.array([list(range(views))]))


def test_train_verb_needs_device_or_cuda(tmp_path):
    """Without --device the verb asks for CUDA and raises without it."""
    from detectorfreesfm_tpu_torch import cli

    data = str(tmp_path / "scenes")
    write_planar_scenes(data)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--data", data, "--output", str(tmp_path / "o"),
                  "--img-resize", "48", "--max-steps", "1"])


def test_megadepth_h5_depth_raises(tmp_path):
    """JAX's loader silently returns zeros for an unreadable depth file;
    the port raises, naming the reader."""
    from detectorfreesfm_tpu_torch.data.megadepth import (
        MegaDepthTupleDataset, SceneIndex)

    write_planar_scenes(str(tmp_path))
    idx = SceneIndex(str(tmp_path), ["s0_im0.png"], ["s0_d0.h5"],
                     np.eye(3)[None], np.array([[1.0, 0, 0, 0]]),
                     np.zeros((1, 3)), np.array([[0]]))
    with pytest.raises(ValueError, match="h5py"):
        MegaDepthTupleDataset(idx, img_size=48)[0]


def test_new_modules_import_no_jax():
    """The training slice imports neither jax, flax, optax nor the JAX
    package (a fresh interpreter that blocks them)."""
    code = (
        "import sys\n"
        "class B:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'flax', 'optax', "
        "'detectorfreesfm_tpu', 'msgpack', 'h5py', 'PIL'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, B())\n"
        "import detectorfreesfm_tpu_torch.train.trainer\n"
        "import detectorfreesfm_tpu_torch.train.matcher_trainer\n"
        "import detectorfreesfm_tpu_torch.train.homography\n"
        "import detectorfreesfm_tpu_torch.train.selfsup\n"
        "import detectorfreesfm_tpu_torch.train.refiner_selfsup\n"
        "import detectorfreesfm_tpu_torch.data.megadepth\n"
        "import detectorfreesfm_tpu_torch.cli\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


# --- JAX_TRAIN record -------------------------------------------------------

def _record_matcher(data, weights, steps, dtype="float32"):
    """`train-matcher --fine [--dtype-train bfloat16]` as JAX's verb runs
    it (its dataset, sampler, MatcherTrainer, load_params), each step JAX's
    loss function and optax update, jitted once: the losses and the
    gradient norms."""
    import glob

    from detectorfreesfm_tpu.data.megadepth import (
        MegaDepthTupleDataset, SceneBalancedSampler, load_scene_index)
    from detectorfreesfm_tpu.models.loftr import MatcherConfig
    from detectorfreesfm_tpu.train.matcher_trainer import (
        MatcherTrainConfig, MatcherTrainer, MatcherTrainState,
        tuple_to_pair_batch)
    from detectorfreesfm_tpu.train.optimizers import (OptimConfig,
                                                      build_optimizer)

    files = sorted(glob.glob(os.path.join(data, "*.npz")))
    from detectorfreesfm_tpu.data.megadepth import shard_scenes

    ds = [MegaDepthTupleDataset(load_scene_index(p), img_size=832)
          for p in shard_scenes(files, 0, 1)]
    ids = SceneBalancedSampler([len(d) for d in ds],
                               n_per_scene=200).epoch(0).tolist()
    jt = MatcherTrainer(MatcherTrainConfig(
        matcher=MatcherConfig(fine_enabled=True, compute_dtype=dtype),
        optim=OptimConfig(true_batch_size=1, backbone_path="backbone")))
    img = jnp.zeros((1, 832, 832, 1))
    params = jax.jit(jt.model.init)(jax.random.PRNGKey(jt.cfg.seed), img, img)
    jt.tx = build_optimizer(jt.cfg.optim, params)
    state = MatcherTrainState(params, jt.tx.init(params), 0)
    state = state._replace(params=jt.load_params(weights, state.params))

    @jax.jit
    def vg(p, a, b, g, u):
        return jax.value_and_grad(lambda q: jt._loss_one(q, a, b, g, u))(p)

    upd = jax.jit(jt.tx.update)
    params, opt = state.params, state.opt_state
    out = dict(losses=[], grad_norms=[])
    for step in range(steps):
        s_, t_ = ids[step]
        batch = tuple_to_pair_batch([ds[s_][t_]])
        gt, uv1 = jt._supervise(batch)
        loss, g = vg(params, jnp.asarray(batch["image0"][0]),
                     jnp.asarray(batch["image1"][0]), jnp.asarray(gt[0]),
                     jnp.asarray(uv1[0]))
        u, opt = upd(g, opt, params)
        params = optax.apply_updates(params, u)
        out["losses"].append(float(loss))
        out["grad_norms"].append(float(optax.global_norm(g)))
        out.setdefault("matched_rows", int((gt[0] >= 0).sum()))
    out.update(loss0=out["losses"][0], grad_norm0=out["grad_norms"][0])
    return out


def _record_refiner(data, weights, steps):
    """`train` as JAX's verb runs it (dataset, sampler, Trainer,
    load_params, fold_in keys), with the warm start cast to fp32 as the
    port's loader casts it, and the port's labels (train/supervision.py:
    JAX's own, but for the reference inputs' rounding ties); JAX's own
    labels' step-0 loss is recorded beside."""
    import glob

    from detectorfreesfm_tpu.data.megadepth import (
        MegaDepthTupleDataset, SceneBalancedSampler, collate,
        load_scene_index, shard_scenes)
    from detectorfreesfm_tpu.models.multiview_matcher import RefinerConfig
    from detectorfreesfm_tpu.train.optimizers import OptimConfig
    from detectorfreesfm_tpu.train.trainer import TrainConfig, Trainer
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        RefinerConfig as TRC)
    from detectorfreesfm_tpu_torch.train import trainer as ttr

    files = sorted(glob.glob(os.path.join(data, "*.npz")))
    ds = [MegaDepthTupleDataset(load_scene_index(p), img_size=832)
          for p in shard_scenes(files, 0, 1)]
    ids = SceneBalancedSampler([len(d) for d in ds],
                               n_per_scene=250).epoch(0).tolist()
    jt = Trainer(TrainConfig(refiner=RefinerConfig(crop_size=19, window=15),
                             optim=OptimConfig(true_batch_size=1),
                             n_tracks=200))
    tt = ttr.Trainer(ttr.TrainConfig(refiner=TRC(crop_size=19, window=15),
                                     n_tracks=200), device=CPU)
    batch = collate([ds[ids[0][0]][ids[0][1]]])
    state = jax_init_state(jt, batch)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float32),
        jt.load_params(weights, state.params))
    opt = jt.tx.init(params)

    @jax.jit
    def vg(p, images, spv):
        return jax.value_and_grad(lambda q: jt._loss_one(q, images, spv))(p)

    upd = jax.jit(jt.tx.update)
    rng = jax.random.PRNGKey(jt.cfg.seed)
    out = dict(losses=[], grad_norms=[])
    for step in range(steps):
        s_, t_ = ids[step]
        batch = collate([ds[s_][t_]])
        key = jax.random.fold_in(rng, step)
        spv = port_labels(tt, batch, key)
        one = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), spv)
        loss, g = vg(params, jnp.asarray(batch["images"][0]), one)
        if step == 0:
            own = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                         jt._supervise(batch, key))
            out["loss0_jax_labels"] = float(vg(
                params, jnp.asarray(batch["images"][0]), own)[0])
            ref_diff = np.abs(np.asarray(own.node_xy)[:, 0]
                              - np.asarray(one.node_xy)[:, 0])
            out["ref_inputs_on_other_tie"] = int((ref_diff > 1e-3).sum())
            out["mask_agreement"] = float(np.mean(
                np.asarray(own.node_mask) == np.asarray(one.node_mask)))
        u, opt = upd(g, opt, params)
        params = optax.apply_updates(params, u)
        out["losses"].append(float(loss))
        out["grad_norms"].append(float(optax.global_norm(g)))
    out.update(loss0=out["losses"][0], grad_norm0=out["grad_norms"][0])
    return out


def _record_matcher_selfsup(images, weights, steps, work,
                            dtype="float32"):
    """`train-matcher-selfsup [--dtype-train bfloat16]` as JAX's verb runs
    it at its defaults: the printed losses of `steps` steps, and step 0's
    exact loss and gradient norm."""
    import io
    from contextlib import redirect_stdout

    from detectorfreesfm_tpu.models.loftr import MatcherConfig
    from detectorfreesfm_tpu.train.selfsup import (load_matcher_params,
                                                   train_matcher_selfsup)
    from test_torch_selfsup import jax_matcher_selfsup_step0, printed_losses

    params = load_matcher_params(weights)
    loss0, norm0 = jax_matcher_selfsup_step0(
        images, params, 416, 4, cfg=MatcherConfig(compute_dtype=dtype))
    buf = io.StringIO()
    with redirect_stdout(buf):
        train_matcher_selfsup(images, os.path.join(work, "m.msgpack"),
                              steps=steps, log_every=1, init_params=params,
                              compute_dtype=dtype)
    return dict(loss0=loss0, grad_norm0=norm0,
                losses=printed_losses(buf.getvalue()))


def _record_selfsup(images, weights, steps, work):
    """Both bootstraps as JAX's verbs run them at their defaults: the
    printed losses of `steps` steps, and step 0's exact loss and gradient
    norm (test_torch_selfsup.py's copies of their step bodies)."""
    import io
    from contextlib import redirect_stdout

    from detectorfreesfm_tpu.models.multiview_matcher import (
        MultiviewRefiner, RefinerConfig)
    from detectorfreesfm_tpu.train.refiner_selfsup import (
        train_refiner_selfsup)
    from test_torch_selfsup import jax_refiner_selfsup_step0, printed_losses

    out = {"matcher_selfsup": _record_matcher_selfsup(images, weights,
                                                      steps, work)}
    v, t = 4, 128
    fresh = MultiviewRefiner(RefinerConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((v, 256, 256, 1)),
        jnp.zeros((t, v), jnp.int32), jnp.zeros((t, v, 2), jnp.float32),
        jnp.ones((t, v), jnp.float32), jnp.zeros((t, v), bool))
    loss0, norm0 = jax_refiner_selfsup_step0(images, fresh, 256, v, t)
    buf = io.StringIO()
    with redirect_stdout(buf):
        train_refiner_selfsup(images, os.path.join(work, "r.msgpack"),
                              steps=steps, log_every=1)
    out["refiner_selfsup"] = dict(loss0=loss0, grad_norm0=norm0,
                                  losses=printed_losses(buf.getvalue()))
    return out


def record(work, dtype="float32"):
    """JAX_TRAIN for chip_smoke.py's `train` phase: the same files (its
    write_train_data), weights and seeds as the phase's verbs. With
    dtype="bfloat16", JAX_TRAIN_BF16 for its `bf16` phase: the two verbs
    that take `--dtype-train`."""
    import time

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    os.makedirs(work, exist_ok=True)
    data, images = cs.write_train_data(work)
    rec, secs = {}, {}
    if dtype != "float32":
        t0 = time.time()
        rec["train_matcher"] = _record_matcher(data, cs.WEIGHTS,
                                               cs.TRAIN_STEPS, dtype)
        rec["matcher_selfsup"] = _record_matcher_selfsup(
            images, cs.WEIGHTS, cs.TRAIN_STEPS, work, dtype)
        print(json.dumps(rec))
        print(json.dumps({"cpu_seconds": time.time() - t0}))
        return
    t0 = time.time()
    rec["train_matcher"] = _record_matcher(data, cs.WEIGHTS, cs.TRAIN_STEPS)
    secs["train_matcher"] = time.time() - t0
    t0 = time.time()
    rec["train"] = _record_refiner(data, cs.REFINER_W, cs.TRAIN_STEPS)
    secs["train"] = time.time() - t0
    t0 = time.time()
    rec.update(_record_selfsup(images, cs.WEIGHTS, cs.TRAIN_STEPS, work))
    secs["selfsup"] = time.time() - t0
    print(json.dumps(rec))
    print(json.dumps({"cpu_seconds": secs}))


if __name__ == "__main__":
    if "--record" in sys.argv:
        import tempfile

        jax.config.update("jax_platforms", "cpu")
        record(sys.argv[sys.argv.index("--work") + 1]
               if "--work" in sys.argv else tempfile.mkdtemp(),
               sys.argv[sys.argv.index("--dtype") + 1]
               if "--dtype" in sys.argv else "float32")
    else:
        raise SystemExit(pytest.main([__file__, "-q"]))
