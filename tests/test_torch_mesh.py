"""The port's device mesh (parallel/mesh.py) and its sharded paths against
the JAX package's mesh runs on the conftest's virtual CPU devices: the
sharding helpers, the pair-matching engine, one refinement iteration,
bundle adjustment, global_ba's mesh choice, and one step of both mesh
trainers with 3 rows on a mesh of 4.

Port meshes repeat the one CPU device (`[cpu] * 4`): every shard runs, on
the same device, what it would run on a card of its own. Tolerances: the
sharded port equals the one-entry port exactly (engine, refinement, BA);
against JAX, those of test_torch_engine.py (matches IoU >= 0.95),
test_torch_refine.py (keypoints 1e-3 px, points 1e-3), tests/test_sfm.py's
sharded BA test (quaternions 1e-4, translations 1e-3, cost 5%) and
test_torch_train.py (loss 1e-5 relative, gradient norm 1e-4, parameters
as Adam's sign-like first step allows).

    JAX_PLATFORMS=cpu python tests/test_torch_mesh.py --record [--work DIR]

records JAX_MESH_TRAIN, the JAX trainers' numbers on a 2-device mesh that
chip_smoke.py's `mesh` phase holds the port to (see `record`).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__" and "--record" in sys.argv:
    # The 2-device mesh of `record`: virtual CPU devices, as the suite's
    # conftest makes them.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from detectorfreesfm_tpu_torch.parallel import mesh as pmesh  # noqa: E402

CPU4 = [torch.device("cpu")] * 4
R4 = os.path.join(REPO, "weights", "demo_refiner_r4_bf16.msgpack")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, beside the suite's other workers (see
    test_torch_refine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh(n):
    from detectorfreesfm_tpu.parallel.mesh import make_mesh

    return make_mesh(n)


# --- parallel/mesh.py --------------------------------------------------------

def test_shard_leading_axis_equals_jax_blocks():
    """Block i of each leaf is the data of JAX's shard on device i of
    make_mesh(4) (rows in order), moved to row i's device."""
    from detectorfreesfm_tpu.parallel.mesh import shard_leading_axis as jsh

    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(8, 3)).astype(np.float32),
            "b": (np.arange(12, dtype=np.int32),
                  rng.normal(size=(4, 2, 2)).astype(np.float32))}
    jtree = jsh(tree, _jax_mesh(4))
    blocks = pmesh.shard_leading_axis(tree, pmesh.make_mesh(devices=CPU4))
    assert len(blocks) == 4
    for jarr, leaf in ((jtree["a"], lambda b: b["a"]),
                       (jtree["b"][0], lambda b: b["b"][0]),
                       (jtree["b"][1], lambda b: b["b"][1])):
        shards = sorted(jarr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        assert [s.device for s in shards] == list(jax.devices()[:4])
        for i, s in enumerate(shards):
            got = leaf(blocks[i])
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_leading_axis(np.zeros(6), pmesh.make_mesh(devices=CPU4))


def test_make_mesh_pad_and_replicate():
    """make_mesh's shape dict as JAX's (model axis too), pad_to_multiple
    as JAX's, and replicate: one copy per distinct device, shared where
    the mesh repeats a device, a leaf already there not copied."""
    from detectorfreesfm_tpu.parallel.mesh import pad_to_multiple as jpad

    for n, m in ((0, 4), (1, 4), (3, 4), (4, 4), (9, 2), (7, 1)):
        assert pmesh.pad_to_multiple(n, m) == jpad(n, m)
    from detectorfreesfm_tpu.parallel.mesh import make_mesh as jmake

    m = pmesh.make_mesh(model_axis=2, devices=CPU4)
    assert m.shape == dict(jmake(4, model_axis=2).shape) == {"data": 2,
                                                             "model": 2}
    assert m.data_devices == CPU4[:2] and m.devices.size == 4
    assert pmesh.make_mesh(2, devices=CPU4).shape == {"data": 2, "model": 1}
    with pytest.raises(ValueError):
        pmesh.make_mesh(3, model_axis=2, devices=CPU4)
    with pytest.raises(ValueError):
        pmesh.make_mesh(5, devices=CPU4)
    t = torch.arange(6.0)
    reps = pmesh.replicate({"w": t, "n": np.ones(2)},
                           pmesh.make_mesh(devices=CPU4))
    assert len(reps) == 4 and all(r is reps[0] for r in reps)
    assert reps[0]["w"] is t
    assert torch.equal(reps[0]["n"], torch.ones(2, dtype=torch.float64))


def test_default_mesh_needs_cuda(monkeypatch):
    """make_mesh() takes the visible cards: without CUDA it raises, and an
    explicit device gives a one-entry mesh (no card needed)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.mesh_of()
    one = pmesh.mesh_of("cpu")
    assert one.shape == {"data": 1, "model": 1}
    assert one.first == torch.device("cpu")
    with pytest.raises(ValueError, match="not both"):
        pmesh.mesh_of("cpu", one)


# --- match/engine.py ---------------------------------------------------------

def _engine_scene(size=128, n_views=3):
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs

    images = generate_scene(1, SyntheticConfig(size=size, n_views=n_views))[0]
    names = [f"view_{i}" for i in range(n_views)]
    return images, names, exhaustive_pairs(names)


def test_engine_on_a_mesh_equals_one_entry_and_jax():
    """3 pairs at 128 px, fused, batch 1 per device: on [cpu] * 4 (one
    step, padded to 4) the matches equal the one-entry engine's exactly,
    and the JAX engine's on make_mesh(4) at IoU >= 0.95."""
    from flax import serialization

    from detectorfreesfm_tpu.data.images import LoadedImage as JaxImage
    from detectorfreesfm_tpu.match.engine import EngineConfig as JCfg
    from detectorfreesfm_tpu.match.engine import PairMatchingEngine as JEng
    from detectorfreesfm_tpu_torch.data.images import from_array
    from detectorfreesfm_tpu_torch.match.engine import (EngineConfig,
                                                        PairMatchingEngine)
    from detectorfreesfm_tpu_torch.ops import fused_dsm
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params
    from test_torch_engine import WEIGHTS, _iou, _rows

    size = 128
    images, names, pairs = _engine_scene(size)
    cfg = EngineConfig(img_resize=size, fine_enabled=True,
                       round_matches_ratio=4, fused_matching=True)
    params = load_matcher_params(WEIGHTS, cfg.matcher_config())
    imgs = {n: from_array(images[i]) for i, n in enumerate(names)}
    one = PairMatchingEngine(cfg, params, device="cpu").match_pairs(pairs,
                                                                    imgs)
    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0
    eng = PairMatchingEngine(cfg, params, mesh=pmesh.make_mesh(devices=CPU4))
    assert len(eng.models) == 4 and all(m is eng.model for m in eng.models)
    four = eng.match_pairs(pairs, imgs)
    assert list(four) == list(one) == pairs
    for p in pairs:
        for k in ("kpts0", "kpts1", "conf"):
            np.testing.assert_array_equal(four[p][k], one[p][k])

    with open(WEIGHTS, "rb") as f:
        raw = serialization.msgpack_restore(f.read())["params"]
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                     raw)
    jeng = JEng(JCfg(img_resize=size, fine_enabled=True,
                     round_matches_ratio=4, batch_size=1),
                params=jparams, mesh=_jax_mesh(4))
    jimgs = {n: JaxImage(images[i], np.ones(2, np.float32), (size, size),
                         (size, size)) for i, n in enumerate(names)}
    jraw = jeng.match_pairs(pairs, jimgs)
    for p in pairs:
        a, b = _rows(jraw[p]), _rows(four[p])
        assert len(a) > 20, (p, len(a))
        assert _iou(a, b) >= 0.95, (p, len(a), len(b))


# --- refine/loop.py ----------------------------------------------------------

@pytest.fixture(scope="module")
def small_model():
    """tests/test_refiner.py's small reconstruction, made once by the JAX
    mapper (as test_torch_refine.py's)."""
    from test_refiner import _small_reconstruction

    return _small_reconstruction()


def test_refinement_on_a_mesh_equals_one_entry_and_jax(small_model,
                                                        monkeypatch):
    """One iteration, r4 weights, window 7, chunks of 64 tracks over
    [cpu] * 4 (16 rows a block): the same keypoints and model as the
    one-entry run with chunks of 16 (the same blocks), bit for bit, and
    JAX's on make_mesh(4) with chunks of 64 at test_torch_refine.py's
    tolerances."""
    from detectorfreesfm_tpu.refine import loop as jloop
    from detectorfreesfm_tpu.train.refiner_selfsup import (
        load_refiner_params as jax_load)
    from detectorfreesfm_tpu_torch.refine.loop import (RefineConfig,
                                                       refine_reconstruction)
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_refiner_params
    from test_torch_refine import _same_model, _scene_images, _to_port

    jrec, jm = copy.deepcopy(small_model)
    images = _scene_images(jrec)
    params = load_refiner_params(R4, device="cpu")
    kw = dict(n_iters=1, windows=(7,), max_track_length=8,
              filter_thresholds=(3.0,))
    runs = []
    for chunk, where in ((16, {"device": "cpu"}),
                         (64, {"mesh": pmesh.make_mesh(devices=CPU4)})):
        rec, m = _to_port(*copy.deepcopy(small_model))
        info = {}
        refine_reconstruction(rec, images, params,
                              RefineConfig(chunk_tracks=chunk, **kw),
                              mapper=m, info=info, **where)
        assert info["iterations_completed"] == 1, info["error"]
        runs.append((rec, info["iterations"][0]))
    (one, it1), (four, it4) = runs
    assert it4["chunks"] == -(-it4["tracks"] // 64)
    assert it1["chunks"] == -(-it1["tracks"] // 16) > it4["chunks"]
    for i, im in one.images.items():
        np.testing.assert_array_equal(four.images[i].xys, im.xys)
        np.testing.assert_array_equal(four.images[i].point3D_ids,
                                      im.point3D_ids)
    assert sorted(four.points) == sorted(one.points)
    for p, pt in one.points.items():
        np.testing.assert_array_equal(four.points[p]["xyz"], pt["xyz"])

    monkeypatch.setattr(jloop, "get_mesh", lambda: _jax_mesh(4))
    jloop.refine_reconstruction(jrec, images, jax_load(R4),
                                jloop.RefineConfig(chunk_tracks=64, **kw),
                                mapper=jm)
    for i, im in jrec.images.items():
        np.testing.assert_allclose(four.images[i].xys, im.xys, atol=1e-3)
    assert sorted(four.registered_images) == sorted(jrec.registered_images)
    _same_model(four, jrec, atol=1e-3)


# --- sfm/ba.py, sfm/mapper.py --------------------------------------------------

def _ba_problem():
    """tests/test_sfm.py's sharded-BA problem (4 cameras, 60 points)."""
    from detectorfreesfm_tpu.core.geometry import rotmat_to_quat
    from test_sfm import _synthetic_scene

    pts, K, Rs, ts, uvs = _synthetic_scene(n_cams=4, n_pts=60, seed=8)
    rng = np.random.default_rng(9)
    C, P = 4, 60
    qvec = np.array(rotmat_to_quat(jnp.asarray(np.stack(Rs))))
    tvec = np.stack(ts)
    tvec[2:] += rng.normal(0, 0.05, (C - 2, 3))
    pts_noisy = pts + rng.normal(0, 0.03, pts.shape)
    obs_uv = np.concatenate(uvs)
    obs_cam = np.repeat(np.arange(C), P)
    obs_pt = np.tile(np.arange(P), C)
    intr = np.tile(np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]), (C, 1))
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    return (qvec, tvec, intr, pts_noisy, obs_uv, obs_cam, obs_pt), dict(
        fixed_cams=fixed, max_iters=10)


@pytest.mark.parametrize("schur_mode", ["dense", "pcg"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_bundle_adjust_on_a_mesh_is_bit_equal(schur_mode, n):
    """Observations padded to a multiple of n (240 + 1 slots) and cut into
    n blocks: poses, intrinsics, points and cost equal the unsharded
    solve's bit for bit, with either Schur solver."""
    from detectorfreesfm_tpu_torch.sfm.ba import bundle_adjust

    args, kw = _ba_problem()
    kw.update(schur_mode=schur_mode, refine_focal=True)
    ref = bundle_adjust(*args, device="cpu", **kw)
    info = {}
    got = bundle_adjust(*args, mesh=pmesh.make_mesh(n, devices=CPU4),
                        info=info, **kw)
    assert info["shards"] == n and info["iterations"] > 1
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_bundle_adjust_on_a_mesh_equals_jax_sharded():
    """The port on [cpu] * 4 against JAX's bundle_adjust on make_mesh()
    (8 devices), at tests/test_sfm.py's tolerances for JAX's own sharded
    and unsharded runs."""
    from detectorfreesfm_tpu.parallel.mesh import make_mesh
    from detectorfreesfm_tpu.sfm.ba import bundle_adjust as jba
    from detectorfreesfm_tpu_torch.sfm.ba import bundle_adjust

    args, kw = _ba_problem()
    q1, t1, _, p1, c1 = jba(*args, mesh=make_mesh(), **kw)
    q2, t2, _, p2, c2 = bundle_adjust(
        *args, mesh=pmesh.make_mesh(devices=CPU4), **kw)
    np.testing.assert_allclose(q2, q1, atol=1e-4)
    np.testing.assert_allclose(t2, t1, atol=1e-3)
    np.testing.assert_allclose(c2, c1, rtol=0.05, atol=1e-4)


def test_global_ba_auto_mesh(small_model, monkeypatch):
    """mesh="auto" passes None with one device (no CUDA here, or a
    default mesh of one entry) and the default mesh when it holds several
    devices starting at the mapper's; an explicit None stays None."""
    from detectorfreesfm_tpu_torch.sfm import mapper as pm
    from test_torch_refine import _to_port

    rec, m = _to_port(*copy.deepcopy(small_model))
    seen = []
    real = pm.bundle_adjust

    def spy(*a, **k):
        seen.append(k.get("mesh"))
        return real(*a, **k)

    monkeypatch.setattr(pm, "bundle_adjust", spy)
    m.global_ba(rec)
    four = pmesh.make_mesh(devices=CPU4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for default in (pmesh.make_mesh(devices=CPU4[:1]), four):
        monkeypatch.setattr(pm, "get_mesh", lambda d=default: d)
        m.global_ba(rec)
    m.global_ba(rec, mesh=None)
    assert seen == [None, None, four, None]


# --- train/trainer.py, train/matcher_trainer.py ------------------------------

def _jax_masked_value_and_grad(loss_one, params, rows, live, mesh):
    """JAX's step loss (sum(losses * live) / max(sum(live), 1), trainer.py
    and matcher_trainer.py) and its gradient, with the rows sharded over
    `mesh` as the step shards them."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def loss_fn(p, rows, live):
        losses = jax.vmap(lambda *r: loss_one(p, *r))(*rows)
        return jnp.sum(losses * live) / jnp.maximum(jnp.sum(live), 1.0)

    put = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                   NamedSharding(mesh, P("data")))
    with mesh:
        return jax.jit(jax.value_and_grad(loss_fn))(
            params, jax.tree_util.tree_map(put, rows), put(live))


def _check_step(tt, jt, jstate, jloss, jgrad, port_step, lr):
    """The port's step against JAX's (its optax chain on the mesh
    gradient: the jitted step would compile the same program again):
    loss 1e-5, gradient norm 1e-4 (both relative), parameters as Adam's
    first step allows."""
    from test_torch_train import assert_adam_step_close, state_of

    upd, _ = jt.tx.update(jgrad, jstate.opt_state, jstate.params)
    jnew = optax.apply_updates(jstate.params, upd)
    tstate2, tloss = port_step()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tt.history[-1]["grad_norm"],
                               float(optax.global_norm(jgrad)), rtol=1e-4)
    assert tstate2.step == 1
    assert_adam_step_close(tstate2.params, state_of(jnew), lr)


def test_trainer_on_a_mesh_equals_jax():
    """3 tuples on [cpu] * 4 (padded to 4 with a copy of row 0, key split
    over the 4 rows as JAX splits it): the labels are JAX's for the padded
    batch (its rounding ties aside), and the step JAX Trainer's on
    make_mesh(4), fed the port's labels."""
    from detectorfreesfm_tpu.train.supervision import SupervisionBatch
    from detectorfreesfm_tpu_torch.train.trainer import Trainer, pad_rows
    from test_torch_train import (_assert_tracks_equal, _refiner_setup,
                                  jax_init_state, planar_tuple, state_of,
                                  t2n)

    jt, tt1, _ = _refiner_setup()
    batch = {k: np.stack([planar_tuple(seed=s)[k] for s in (0, 1, 2)])
             for k in ("images", "depths", "K", "qvec", "tvec")}
    jstate = jax_init_state(jt, batch)
    rng = jax.random.fold_in(jax.random.PRNGKey(jt.cfg.seed), 0)
    tt = Trainer(tt1.cfg, mesh=pmesh.make_mesh(devices=CPU4))
    tstate = tt.init_state(batch)._replace(params=state_of(jstate.params))
    padded = pad_rows(batch, 4)
    spvs = tt.supervise(padded, np.asarray(rng))
    jspv = jt._supervise(padded, rng)
    for i, s in enumerate(spvs):
        _assert_tracks_equal(jax.tree_util.tree_map(lambda a: a[i], jspv), s)
    port_spv = SupervisionBatch(*(np.stack([t2n(getattr(s, f))
                                            for s in spvs])
                                  for f in SupervisionBatch._fields))
    jloss, jgrad = _jax_masked_value_and_grad(
        jt._loss_one, jstate.params, (padded["images"], port_spv),
        np.array([1, 1, 1, 0], np.float32), _jax_mesh(4))
    _check_step(tt, jt, jstate, jloss, jgrad,
                lambda: tt.train_step(tstate, batch, np.asarray(rng)),
                2e-3 * 2 / 4)


def test_matcher_trainer_on_a_mesh_equals_jax():
    """3 pairs, the fine stage on, on [cpu] * 4 against JAX
    MatcherTrainer's step on make_mesh(4), on JAX's labels of the padded
    batch: loss, gradient norm and parameters after the step."""
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        MatcherTrainer)
    from detectorfreesfm_tpu_torch.train.trainer import pad_rows
    from test_torch_train import state_of
    from test_torch_train_matcher import (jax_matcher_trainer, pair_batch,
                                          port_matcher_trainer)

    batch = pair_batch(seeds=(0, 1, 2))
    jt, jstate = jax_matcher_trainer(True)
    tt = MatcherTrainer(port_matcher_trainer(True).cfg,
                        mesh=pmesh.make_mesh(devices=CPU4))
    tstate = tt.init_state(batch)._replace(params=state_of(jstate.params))
    padded = pad_rows(batch, 4)
    gt, uv1 = jt._supervise(padded)
    jloss, jgrad = _jax_masked_value_and_grad(
        jt._loss_one, jstate.params,
        (padded["image0"], padded["image1"], gt, uv1),
        np.array([1, 1, 1, 0], np.float32), _jax_mesh(4))
    _check_step(tt, jt, jstate, jloss, jgrad,
                lambda: tt.train_step(tstate, batch), 5e-4 * 2 / 4)


# --- JAX_MESH_TRAIN record ------------------------------------------------------

def record(work):
    """JAX_MESH_TRAIN for chip_smoke.py's `mesh` phase (gate d): on the
    train phase's files (its write_train_data), the first 3 tuples at
    MESH_TRAIN_SIZE, JAX's Trainer (r4 warm start cast to fp32, window
    15, 200 tracks, the port's labels from fold_in(seed, 0) split over the
    padded rows, as chip_smoke feeds its trainer) and MatcherTrainer
    (--fine, r5 warm start) steps' loss and gradient norm on a 2-device
    mesh, 3 rows padded to 4."""
    import json
    import time

    import chip_smoke as cs
    from detectorfreesfm_tpu.data.megadepth import collate as jcollate
    from detectorfreesfm_tpu.models.loftr import MatcherConfig
    from detectorfreesfm_tpu.models.multiview_matcher import RefinerConfig
    from detectorfreesfm_tpu.train.matcher_trainer import (
        MatcherTrainConfig, MatcherTrainer, MatcherTrainState)
    from detectorfreesfm_tpu.train.optimizers import (OptimConfig,
                                                      build_optimizer)
    from detectorfreesfm_tpu.train.supervision import SupervisionBatch
    from detectorfreesfm_tpu.train.trainer import TrainConfig, Trainer
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        RefinerConfig as TRC)
    from detectorfreesfm_tpu_torch.train import trainer as ttr
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        tuple_to_pair_batch)
    from test_torch_train import jax_init_state, t2n

    os.makedirs(work, exist_ok=True)
    data, _images = cs.write_train_data(work)
    tuples = cs.mesh_train_tuples(data)
    live = np.array([1, 1, 1, 0], np.float32)
    mesh = _jax_mesh(2)
    out, secs = {}, {}

    t0 = time.time()
    batch = jcollate(tuples)
    jt = Trainer(TrainConfig(refiner=RefinerConfig(crop_size=19, window=15),
                             optim=OptimConfig(true_batch_size=3),
                             n_tracks=200), mesh=mesh)
    state = jax_init_state(jt, batch)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                    jt.load_params(cs.REFINER_W,
                                                   state.params))
    tt = ttr.Trainer(ttr.TrainConfig(refiner=TRC(crop_size=19, window=15),
                                     n_tracks=200), device="cpu")
    padded = ttr.pad_rows(batch, 4)
    rng = jax.random.fold_in(jax.random.PRNGKey(jt.cfg.seed), 0)
    spvs = tt.supervise(padded, np.asarray(rng))
    spv = SupervisionBatch(*(np.stack([t2n(getattr(s, f)) for s in spvs])
                             for f in SupervisionBatch._fields))
    loss, g = _jax_masked_value_and_grad(jt._loss_one, params,
                                         (padded["images"], spv), live, mesh)
    out["train"] = dict(loss=float(loss),
                        grad_norm=float(optax.global_norm(g)))
    secs["train"] = time.time() - t0

    t0 = time.time()
    pairs = tuple_to_pair_batch(tuples)
    mt = MatcherTrainer(MatcherTrainConfig(
        matcher=MatcherConfig(fine_enabled=True),
        optim=OptimConfig(true_batch_size=3, backbone_path="backbone")),
        mesh=mesh)
    img = jnp.zeros((1,) + pairs["image0"].shape[1:])
    mparams = jax.jit(mt.model.init)(jax.random.PRNGKey(mt.cfg.seed), img,
                                     img)
    mt.tx = build_optimizer(mt.cfg.optim, mparams)
    mstate = MatcherTrainState(mparams, mt.tx.init(mparams), 0)
    mparams = mt.load_params(cs.WEIGHTS, mstate.params)
    padded = ttr.pad_rows(pairs, 4)
    gt, uv1 = mt._supervise(padded)
    loss, g = _jax_masked_value_and_grad(
        mt._loss_one, mparams,
        (padded["image0"], padded["image1"], gt, uv1), live, mesh)
    out["train_matcher"] = dict(loss=float(loss),
                                grad_norm=float(optax.global_norm(g)))
    secs["train_matcher"] = time.time() - t0
    print(json.dumps(out))
    print(json.dumps({"cpu_seconds": secs}))


if __name__ == "__main__":
    if "--record" in sys.argv:
        import tempfile

        jax.config.update("jax_platforms", "cpu")
        record(sys.argv[sys.argv.index("--work") + 1]
               if "--work" in sys.argv else tempfile.mkdtemp())
    else:
        raise SystemExit(pytest.main([__file__, "-q"]))
