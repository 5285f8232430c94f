"""The port's matcher training against the JAX package on the CPU:
`pair_cell_assignment`, the matcher's `return_conf`/`fine_at` paths,
MatcherTrainer's coarse and joint-fine steps, its warm start and the
`train-matcher` verb. One (self, cross) layer, 64 px planar pairs.

Tolerances: labels equal (99.9% on a rendered scene); the confidence and
the fine head's outputs 1e-5 relative; losses 1e-5 relative, the
gradient norm 1e-4, each leaf's gradient within 1e-2 of its largest value
(two channels of layer1_1.bn1, 9 and 79, differ by 8e-3 and 1.1e-3 and
every other by under 3e-6: ReLU inputs that one side sums to an exact 0
and the other to a float32 residue, whose gradient then flows back into
the earlier layers; see test_torch_train.py for the refiner), parameters
after a step as Adam's sign-like step allows.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_torch_train import (CPU, assert_adam_step_close,  # noqa: E402
                              assert_leaves_close, planar_tuple, state_of,
                              t2n)

torch.set_num_threads(1)
KEYS = ("depth0", "depth1", "K0", "K1", "q0", "t0", "q1", "t1")


def pair_batch(size=64, seeds=(0, 1)):
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        tuple_to_pair_batch)

    return tuple_to_pair_batch([planar_tuple(v=2, size=size, seed=s)
                                for s in seeds])


def _assign_both(batch, i):
    from detectorfreesfm_tpu.train.matcher_supervision import (
        pair_cell_assignment as jpca)
    from detectorfreesfm_tpu_torch.train.matcher_supervision import (
        pair_cell_assignment)

    a = jpca(*(jnp.asarray(batch[k][i]) for k in KEYS))
    b = pair_cell_assignment(*(torch.tensor(batch[k][i]) for k in KEYS))
    return [np.asarray(x) for x in a], [t2n(x) for x in b]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_cell_assignment_equal(seed):
    batch = pair_batch(seeds=(seed,))
    (jg, ju), (tg, tu) = _assign_both(batch, 0)
    assert tg.dtype == np.int32 and (jg == tg).all()
    assert (jg >= 0).sum() > 10
    np.testing.assert_allclose(tu, ju, atol=1e-4, rtol=1e-5)


def test_pair_cell_assignment_rendered_scene():
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)

    _i, d, K, q, t = generate_scene(5, SyntheticConfig(size=256, n_views=2))
    batch = {"depth0": d[:1], "depth1": d[1:], "K0": K[:1], "K1": K[1:],
             "q0": q[:1], "t0": t[:1], "q1": q[1:], "t1": t[1:]}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    (jg, ju), (tg, tu) = _assign_both(batch, 0)
    assert (jg >= 0).sum() > 200
    assert np.mean(jg == tg) >= 0.999
    same = jg == tg
    np.testing.assert_allclose(tu[same], ju[same], atol=2e-3, rtol=1e-5)


def jax_matcher(fine, layers=1, border=1):
    from detectorfreesfm_tpu.models.loftr import DetectorFreeMatcher
    from detectorfreesfm_tpu.models.loftr import MatcherConfig as JC

    return DetectorFreeMatcher(JC(n_coarse_layers=layers, max_matches=32,
                                  border=border, fine_enabled=fine))


def port_matcher(fine, layers=1, border=1, fused=False):
    from detectorfreesfm_tpu_torch.models.loftr import (DetectorFreeMatcher,
                                                        MatcherConfig)

    return DetectorFreeMatcher(MatcherConfig(
        n_coarse_layers=layers, max_matches=32, border=border,
        fine_enabled=fine, fused_matching=fused))


def jax_matcher_trainer(fine, n_fine=16):
    from detectorfreesfm_tpu.models.loftr import MatcherConfig as JC
    from detectorfreesfm_tpu.train.matcher_trainer import (
        MatcherTrainConfig as JMC, MatcherTrainer as JMT, MatcherTrainState)
    from detectorfreesfm_tpu.train.optimizers import OptimConfig as JOC
    from detectorfreesfm_tpu.train.optimizers import build_optimizer

    jt = JMT(JMC(matcher=JC(n_coarse_layers=1, max_matches=32, border=1,
                            fine_enabled=fine),
                 optim=JOC(canonical_lr=5e-4, true_batch_size=2,
                           milestones=(1000,)), n_fine=n_fine))
    img = jnp.zeros((1, 64, 64, 1))
    params = jax.jit(jt.model.init)(jax.random.PRNGKey(jt.cfg.seed), img, img)
    jt.tx = build_optimizer(jt.cfg.optim, params)
    state = MatcherTrainState(params, jt.tx.init(params),
                              jnp.zeros((), jnp.int32))
    return jt, state


def port_matcher_trainer(fine, n_fine=16):
    from detectorfreesfm_tpu_torch.models.loftr import MatcherConfig
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        MatcherTrainConfig, MatcherTrainer)
    from detectorfreesfm_tpu_torch.train.optimizers import OptimConfig

    return MatcherTrainer(MatcherTrainConfig(
        matcher=MatcherConfig(n_coarse_layers=1, max_matches=32, border=1,
                              fine_enabled=fine),
        optim=OptimConfig(canonical_lr=5e-4, true_batch_size=2,
                          milestones=(1000,)), n_fine=n_fine), device=CPU)


@pytest.mark.parametrize("fine", [False, True], ids=["coarse", "fine"])
def test_matcher_trainer_step_equals_jax(fine):
    """Same params, pairs and labels: the loss, the gradient of every leaf
    (BatchNorm statistics included: JAX differentiates the whole variables
    tree) and one optimizer step."""
    batch = pair_batch()
    jt, jstate = jax_matcher_trainer(fine)
    tt = port_matcher_trainer(fine)
    tstate = tt.init_state(batch)
    assert set(tstate.params) == set(state_of(jstate.params))
    assert any(k.startswith("fine_match.") for k in tstate.params) == fine
    tstate = tstate._replace(params=state_of(jstate.params))

    gt, uv1 = jt._supervise(batch)
    tgt, tuv = tt.supervise(batch)
    assert (t2n(tgt) == gt).all()

    def loss_fn(p):
        return jnp.mean(jax.vmap(lambda a, b, g, u: jt._loss_one(
            p, a, b, g, u))(jnp.asarray(batch["image0"]),
                            jnp.asarray(batch["image1"]), jnp.asarray(gt),
                            jnp.asarray(uv1)))

    jl, jg = jax.value_and_grad(loss_fn)(jstate.params)
    tl, tg = tt.loss_and_grads(tstate.params, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_leaves_close(tg, state_of(jg), 1e-2)
    assert float(torch.abs(tg["backbone.bn1.running_mean"]).max()) > 0

    upd, _ = jt.tx.update(jg, jstate.opt_state, jstate.params)
    jparams = optax.apply_updates(jstate.params, upd)
    tstate2, tloss = tt.train_step(tstate, batch)
    np.testing.assert_allclose(float(tloss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tt.history[0]["grad_norm"],
                               float(optax.global_norm(jg)), rtol=1e-4)
    assert_adam_step_close(tstate2.params, state_of(jparams), 5e-4 * 2 / 4)


def test_unported_arch_raises(tmp_path):
    """Every family trains; what JAX cannot run, an alt family with the
    fine stage (its model takes no `fine_at`), raises when the trainer is
    built, and the verb exits with its message."""
    from detectorfreesfm_tpu_torch import cli
    from detectorfreesfm_tpu_torch.models.loftr import MatcherConfig
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        MatcherTrainConfig, MatcherTrainer)

    for arch in ("aspan", "matchformer"):
        with torch.device("meta"):
            assert MatcherTrainer(MatcherTrainConfig(arch=arch),
                                  device=CPU).cfg.arch == arch
    with pytest.raises(ValueError, match="no fine stage"):
        MatcherTrainer(MatcherTrainConfig(
            arch="aspan", matcher=MatcherConfig(fine_enabled=True)),
            device=CPU)
    from test_torch_train import write_planar_scenes

    write_planar_scenes(str(tmp_path), size=64, views=2)
    with pytest.raises(SystemExit, match="no fine stage"):
        cli.main(["train-matcher", "--arch", "aspan", "--fine", "--data",
                  str(tmp_path), "--output", str(tmp_path / "out"),
                  "--img-resize", "64", "--device", "cpu"])
    assert not (tmp_path / "out").exists()
