"""The port's matcher `return_conf`/`fine_at` paths, checkpoints,
flax-style init and `train-matcher` verb against the JAX package on the
CPU (the trainer's steps are in
test_torch_train_matcher.py, whose helpers these tests use)."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_train import (CPU, assert_leaves_close,  # noqa: E402
                              state_of, t2n, write_planar_scenes)
from test_torch_train_matcher import (jax_matcher,  # noqa: E402
                                      jax_matcher_trainer, pair_batch,
                                      port_matcher, port_matcher_trainer)

torch.set_num_threads(1)


@pytest.mark.parametrize("fused", [False, True])
def test_return_conf_and_fine_at_equal(fused):
    """return_conf gives the dense confidence (the dense path even with the
    fused kernels asked for) and fine_at the fine head at the teacher
    cells; the parameters come from the JAX init through the converter."""
    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, 1, (1, 64, 64, 1)).astype(np.float32)
    x1 = rng.uniform(0, 1, (1, 64, 64, 1)).astype(np.float32)
    jm = jax_matcher(fine=True)
    jv = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x0),
                          jnp.asarray(x1))
    idx0 = np.array([[9, 10, 27, 40]], np.int32)
    idx1 = np.array([[9, 12, 26, 63]], np.int32)
    jout, jconf, (jd, js) = jax.jit(lambda v, a, b, i0, i1: jm.apply(
        v, a, b, return_conf=True, fine_at=(i0, i1)))(
        jv, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(idx0),
        jnp.asarray(idx1))
    tm = port_matcher(fine=True, fused=fused)
    tm.load_state_dict(state_of(jv))
    with torch.no_grad():
        tout, tconf, (td, ts) = tm(
            torch.tensor(x0), torch.tensor(x1), return_conf=True,
            fine_at=(torch.tensor(idx0), torch.tensor(idx1)))
        plain, pconf = tm(torch.tensor(x0), torch.tensor(x1),
                          return_conf=True)
        bare = tm(torch.tensor(x0), torch.tensor(x1))
    np.testing.assert_allclose(t2n(tconf), np.asarray(jconf), rtol=1e-4,
                               atol=1e-5 * float(jnp.abs(jconf).max()))
    np.testing.assert_allclose(t2n(td), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(t2n(ts), np.asarray(js), atol=1e-5)
    assert torch.equal(pconf, tconf)
    valid = np.asarray(jout.valid)
    assert (t2n(tout.valid) == valid).all()
    np.testing.assert_allclose(t2n(tout.coords1)[valid],
                               np.asarray(jout.coords1)[valid], atol=1e-3)
    assert type(bare).__name__ == "MatchOutput"


def test_matcher_warm_start_keeps_fresh_fine_head(tmp_path, capsys):
    """A coarse-only checkpoint warm-starts a joint run: shared leaves load,
    the fine head keeps its fresh values, with JAX's warning; a shape
    mismatch raises."""
    batch = pair_batch()
    coarse = port_matcher_trainer(False)
    cstate = coarse.init_state(batch)
    path = str(tmp_path / "coarse.msgpack")
    coarse.save_checkpoint(cstate, path)
    jt, jstate = jax_matcher_trainer(True)
    capsys.readouterr()
    jmerged = jt.load_params(path, jstate.params)
    want = capsys.readouterr().out
    fine = port_matcher_trainer(True)
    fstate = fine.init_state(batch)
    merged = fine.load_params(path, fstate.params)
    got = capsys.readouterr().out
    assert want.startswith("warm-start: 1 fresh subtrees") and got == want
    for k, v in merged.items():
        src = fstate.params if k.startswith("fine_match.") else cstate.params
        assert torch.equal(v, src[k]), k
    assert_leaves_close(state_of(jmerged), {
        k: (state_of(jstate.params)[k] if k.startswith("fine_match.")
            else v) for k, v in merged.items()}, 0.0)
    bad = dict(fstate.params)
    bad["backbone.conv1.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        fine.load_params(path, bad)


def test_fresh_init_matches_flax_distribution_matcher():
    """The port's flax-style init of the whole matcher against flax's:
    per-leaf std within 10% (leaves of at least 256 values), constant
    leaves equal."""
    from detectorfreesfm_tpu.models.loftr import DetectorFreeMatcher as JM
    from detectorfreesfm_tpu.models.loftr import MatcherConfig as JC
    from detectorfreesfm_tpu_torch.models.loftr import (DetectorFreeMatcher,
                                                        MatcherConfig)
    from detectorfreesfm_tpu_torch.train import trainer as tr

    x = jnp.zeros((1, 64, 64, 1))
    jv = jax.jit(JM(JC(fine_enabled=True)).init)(jax.random.PRNGKey(0), x, x)
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


def test_train_matcher_verb(tmp_path):
    """`train-matcher --fine` on the CPU from a JAX-written warm start:
    checkpoints that JAX's MatcherTrainer and load_matcher_params read,
    finite logged losses, and bf16 training refused."""
    from detectorfreesfm_tpu.train.selfsup import load_matcher_params
    from detectorfreesfm_tpu_torch import cli

    data = str(tmp_path / "scenes")
    write_planar_scenes(data, size=64, views=2)
    jt, jstate = jax_matcher_trainer(True)
    init = str(tmp_path / "init.msgpack")
    jt.save_checkpoint(jstate, init)
    log = str(tmp_path / "log.jsonl")
    args = ["train-matcher", "--data", data, "--output",
            str(tmp_path / "out"), "--epochs", "1", "--img-resize", "64",
            "--samples-per-scene", "1", "--log-every", "1", "--fine",
            "--init-ckpt", init, "--device", "cpu", "--log-json", log]
    from detectorfreesfm_tpu_torch.models import loftr

    cfg = loftr.MatcherConfig
    try:  # the verb's matcher at this test's size
        loftr.MatcherConfig = lambda **kw: cfg(n_coarse_layers=1, border=1,
                                               max_matches=32, **kw)
        assert cli.main(args) == 0
    finally:
        loftr.MatcherConfig = cfg
    path = str(tmp_path / "out" / "matcher_ep0.msgpack")
    back = jt.load_params(path, jstate.params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jstate.params)
    from detectorfreesfm_tpu.models.loftr import MatcherConfig as JC

    jl = load_matcher_params(path, img_size=64, cfg=JC(
        n_coarse_layers=1, border=1, max_matches=32, fine_enabled=True))
    assert_leaves_close(state_of(jl), state_of(back), 0.0)
    import json

    with open(log) as f:
        steps = [json.loads(ln) for ln in f]
    assert len(steps) == 2 and all(np.isfinite(s["loss"]) for s in steps)
    with pytest.raises(SystemExit, match="item 12"):
        cli.main(args + ["--dtype-train", "bfloat16"])
