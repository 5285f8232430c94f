"""The port's MatchFormer matcher (models/matchformer.py) against the JAX
package on the CPU, and its checkpoints in both directions.

Inputs come from numpy seeds; weights from a JAX init (MatchFormer has no
bundled checkpoint), carried across with utils/checkpoint.py's
conversion.

fp32 tolerances: SRAttention within 1e-5 of its output's largest value,
above and below the 4096-query chunk, and its input gradient (through the
chunks' recomputation) within 1e-5 of the gradient's largest value; the
whole matcher (144 px, so that stage 0's 5 184 queries take two chunks)
by its match set, IoU >= 0.99 with the valid count within 1%, and its
dense confidence within 1e-4 of its largest value; one training step:
loss 1e-5 and gradient norm 1e-4 relative. bf16: the criteria of
tests/test_torch_bf16.py (bf16_errors), and match sets at the IoU floor
stated in the test. Checkpoints: bit-equal after a round trip. With a
profiler running (the spans and the counter recording), outputs
bit-equal to those without one.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from detectorfreesfm_tpu.models import build_matcher as jax_build  # noqa
from detectorfreesfm_tpu.models import matchformer as jax_mf  # noqa: E402
from detectorfreesfm_tpu_torch.models import build_matcher  # noqa: E402
from detectorfreesfm_tpu_torch.models import matchformer  # noqa: E402
from detectorfreesfm_tpu_torch.utils import checkpoint  # noqa: E402
from test_torch_aspan import (DTYPES, JAX_DT, TORCH_DT,  # noqa: E402
                              alt_train_step_runs, check_alt_train_step,
                              check_matcher_runs, matcher_runs)
from test_torch_bf16 import bf16_errors, jax_tree_fp32, jjit  # noqa: E402
from test_torch_train import state_of, t2n  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs this file beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (query grid, key grid, reduction): 4 608 queries take two 4096-query
# chunks; the other case is one chunk, and cross-attention to another map.
SR_CASES = {"two_chunks_self": ((72, 64), None, 8),
            "one_chunk_cross": ((24, 20), (24, 20), 4)}


def _sr_inputs(case, seed=0, dim=64):
    (h, w), other, _sr = SR_CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (1, h * w, dim)).astype(np.float32)
    src = (x.reshape(1, h, w, dim) if other is None else
           rng.normal(0, 1, (1, *other, dim)).astype(np.float32))
    return x, src


@pytest.fixture(scope="module")
def sr_runs():
    """JAX and the port on each case in both dtypes, and fp32 input
    gradients of a seeded projection of the output."""
    runs = {}
    for case, (_q, _k, sr) in SR_CASES.items():
        x, src = _sr_inputs(case)
        jmod = jax_mf.SRAttention(64, 8, sr)
        variables = jax.jit(jmod.init)(jax.random.PRNGKey(5), x, src)
        for dt in DTYPES:
            jx, js = (jnp.asarray(a, JAX_DT[dt]) for a in (x, src))
            ref = jjit(jax_mf.SRAttention(64, 8, sr, JAX_DT[dt]).apply)(
                variables, jx, js)
            tmod = matchformer.SRAttention(64, 8, sr, TORCH_DT[dt]).eval()
            tmod.load_state_dict(state_of(variables))
            with torch.no_grad():
                ours = tmod(*(torch.from_numpy(a).to(TORCH_DT[dt])
                              for a in (x, src)))
            assert ours.dtype == TORCH_DT[dt] and ref.dtype == JAX_DT[dt]
            runs[case, dt] = (np.asarray(ref, np.float32), ours)
        proj = np.random.default_rng(1).normal(
            0, 1, (1, x.shape[1], 64)).astype(np.float32)
        jg = jax.jit(jax.grad(lambda a, b: jnp.sum(
            jmod.apply(variables, a, b) * proj), argnums=(0, 1)))(x, src)
        tx, ts = (torch.from_numpy(a).requires_grad_() for a in (x, src))
        (tmod_fp32 := matchformer.SRAttention(64, 8, sr)).load_state_dict(
            state_of(variables))
        (tmod_fp32(tx, ts) * torch.from_numpy(proj)).sum().backward()
        runs[case, "grad"] = ([np.asarray(g) for g in jg],
                              [tx.grad.numpy(), ts.grad.numpy()])
    return runs


@pytest.mark.parametrize("case", sorted(SR_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_sr_attention_matches_jax(sr_runs, case, dtype):
    """bf16: two chunks (3.0e-5, 4.4e-3, 4.4e-3), one chunk (1.2e-4,
    4.4e-3, 4.4e-3)."""
    ref, ours = sr_runs[case, dtype]
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        for jg, tg in zip(*sr_runs[case, "grad"]):
            np.testing.assert_allclose(tg, jg, rtol=0,
                                       atol=1e-5 * np.abs(jg).max())
    else:
        r32, p32 = sr_runs[case, "float32"]
        bf16_errors(ours, ref, r32, p32)


def test_sr_attention_recomputes_chunks_under_autograd(monkeypatch):
    """Under autograd every query chunk goes through
    torch.utils.checkpoint (JAX's jax.checkpoint); without it, none."""
    calls = []
    real = matchformer.checkpoint

    def counting(fn, *args, **kw):
        calls.append(args[0].shape[2])
        return real(fn, *args, **kw)

    monkeypatch.setattr(matchformer, "checkpoint", counting)
    x, src = _sr_inputs("two_chunks_self")
    mod = matchformer.SRAttention(64, 8, 8)
    tx = torch.from_numpy(x).requires_grad_()
    mod(tx, torch.from_numpy(src)).sum().backward()
    assert calls == [4096, 512] and tx.grad is not None
    calls.clear()
    with torch.no_grad():
        mod(torch.from_numpy(x), torch.from_numpy(src))
    assert calls == []


@pytest.fixture(scope="module")
def fresh_vars():
    """A JAX init of the full MatchFormer at 144 px."""
    img = jnp.zeros((1, 144, 144, 1))
    return jax.jit(jax_build("matchformer").init)(jax.random.PRNGKey(7), img,
                                                  img)


def test_matchformer_matcher_matches_jax(fresh_vars):
    """The full model from a JAX init at 144 px, threshold 0, on a batch
    of a distinct pair and a self pair. Random weights give a distinct
    pair near-ties (a row's best cell beats its second by 0.6% at the
    median; JAX bf16 keeps 74% of JAX fp32's matches), so the match sets
    are held on the self pair, whose mutual-NN cells are the diagonal,
    and the numbers on both: fp32 IoU 1.0 (0.992 on the distinct pair);
    bf16 IoU 1.0, held at >= 0.99.

    The dense conf in bf16: (3.7e-3, 3.0e-3, 3.0e-3), held with
    bf16_errors' gap sqrt(2). Each SRAttention alone rounds where JAX does
    (test_sr_attention_matches_jax: 30x under JAX's own gap), but the
    pooled keys amplify one-ulp differences of the two BLAS libraries'
    accumulation order: 1e-5 of the elements differ after the first
    layer's projections, 13% after the first cross layer. The two bf16
    runs are then two draws of one rounding noise, each as far from fp32
    as the other (criterion (2) holds at 1.0x)."""
    runs = matcher_runs("matchformer", fresh_vars, state_of(fresh_vars),
                        144, self_pair=True, match_threshold=0.0)
    check_matcher_runs(runs, iou_floor_bf16=0.99, n_min=40, b=1,
                       gap=2.0 ** 0.5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_spans_leave_the_outputs_bit_equal(dtype):
    """A 96 px batch of two pairs with a torch profiler running (so that
    every span and the counter record) and without one: every output and
    the dense confidence bit-equal."""
    from torch.profiler import ProfilerActivity, profile

    torch.manual_seed(3)
    model = build_matcher("matchformer", compute_dtype=dtype,
                          match_threshold=0.0).eval()
    rng = np.random.default_rng(4)
    x0, x1 = (torch.from_numpy(rng.uniform(size=(2, 96, 96, 1)).astype(
        np.float32)) for _ in range(2))
    with torch.no_grad():
        plain = model(x0, x1, return_conf=True)
        with profile(activities=[ProfilerActivity.CPU]):
            traced = model(x0, x1, return_conf=True)
    out, conf = plain
    assert int(out.valid.sum()) > 0
    for a, b in zip(list(out) + [conf], list(traced[0]) + [traced[1]]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture(scope="module")
def matchformer_step():
    return alt_train_step_runs("matchformer", stage_blocks=(1, 1, 1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_matchformer_train_step_equals_jax(matchformer_step, dtype):
    """MatchFormer with one block per stage (the full model's JAX
    gradient compiles 10 s longer), 64 px planar pairs. bf16: the loss
    (4.8e-6, 2.9e-6, 7.7e-6), the gradient norm (3.9e-4, 1.1e-3,
    6.7e-4)."""
    check_alt_train_step(matchformer_step, dtype)


def test_checkpoints_cross_both_ways(tmp_path, fresh_vars):
    """A port trainer's MatchFormer checkpoint read by JAX's CLI restore
    (`_from_bytes_any` into a template init) and by its trainer's warm
    start; a JAX trainer's checkpoint read strictly by the port
    (load_arch_params). Every leaf bit-equal."""
    from detectorfreesfm_tpu.train.matcher_trainer import (
        MatcherTrainConfig as JMC, MatcherTrainer as JMT)
    from detectorfreesfm_tpu.train.selfsup import _from_bytes_any
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        MatcherTrainConfig, MatcherTrainer)
    from detectorfreesfm_tpu_torch.train.trainer import TrainState

    tt = MatcherTrainer(MatcherTrainConfig(arch="matchformer"), device="cpu")
    params = tt.init_state().params
    path = str(tmp_path / "port.msgpack")
    tt.save_checkpoint(TrainState(params, None, 3), path)
    with open(path, "rb") as f:
        restored = state_of(_from_bytes_any(fresh_vars, f.read(), path))
    jt = JMT(JMC(arch="matchformer"))
    warm = state_of(jt.load_params(path, fresh_vars))
    for got in (restored, warm):
        assert set(got) == set(params)
        assert all(torch.equal(got[k], params[k]) for k in params)

    jpath = str(tmp_path / "jax.msgpack")
    jt.save_checkpoint(type("S", (), dict(params=fresh_vars, step=1)), jpath)
    state = checkpoint.load_arch_params(jpath, "matchformer")
    want = state_of(fresh_vars)
    assert all(torch.equal(state[k], want[k]) for k in want)
    assert set(state) == set(want)
    tt.load_params(jpath, params)  # the port's warm start, strictly
    with pytest.raises(ValueError, match="does not fit"):
        checkpoint.load_arch_params(jpath, "aspan")


def test_fresh_init_matches_flax_distribution(fresh_vars):
    """The trainer's flax-style init of MatchFormer (init_leaves) against
    flax's: the same leaves, per-leaf std within 10% (leaves of at least
    256 values), constant leaves equal."""
    from detectorfreesfm_tpu_torch.train import trainer as tr

    port = tr.init_leaves(build_matcher("matchformer"), 66, "cpu")
    want = state_of(fresh_vars)
    assert set(port) == set(want)
    for k, w in want.items():
        a, b = t2n(port[k]), t2n(w)
        if b.std() == 0:
            assert (a == b).all(), k
        elif b.size >= 256:
            assert abs(a.std() / b.std() - 1) < 0.1, (k, a.std(), b.std())


@pytest.mark.parametrize("arch", ["aspan", "matchformer"])
def test_train_matcher_verb_alt_arch(tmp_path, fresh_vars, arch):
    """`train-matcher --arch` on the CPU at 64 px, two steps: ASpan from
    the bundled file (--init-ckpt), MatchFormer from a fresh init; finite
    logged losses, a checkpoint that the port reads strictly and JAX's
    CLI restores, and the trained MatchFormer served by the verb (it
    completes and stores its matches; its weights are three steps from
    random, so its model is not gated)."""
    import json

    from detectorfreesfm_tpu.train.selfsup import _from_bytes_any
    from detectorfreesfm_tpu_torch import cli, pipeline
    from test_torch_train import write_planar_scenes

    import chip_smoke

    data = str(tmp_path / "scenes")
    write_planar_scenes(data, size=64, views=2)
    log = str(tmp_path / "log.jsonl")
    argv = ["train-matcher", "--arch", arch, "--data", data, "--output",
            str(tmp_path / "out"), "--epochs", "1", "--img-resize", "64",
            "--samples-per-scene", "1", "--log-every", "1", "--device",
            "cpu", "--log-json", log]
    if arch == "aspan":
        argv += ["--init-ckpt", chip_smoke.ASPAN_WEIGHTS]
    assert cli.main(argv) == 0
    with open(log) as f:
        steps = [json.loads(ln) for ln in f]
    assert len(steps) == 2 and all(np.isfinite(s["loss"]) for s in steps)
    path = str(tmp_path / "out" / "matcher_ep0.msgpack")
    state = checkpoint.load_arch_params(path, arch)
    # The JAX CLI restores into a template of the model's variables: a JAX
    # init (MatchFormer), or the bundled file's tree (ASpan's, the same).
    template = fresh_vars if arch == "matchformer" else jax_tree_fp32(
        chip_smoke.ASPAN_WEIGHTS)
    with open(path, "rb") as f:
        restored = state_of(_from_bytes_any(template, f.read(), path))
    assert set(restored) == set(state)
    assert all(torch.equal(restored[k], state[k]) for k in state)
    if arch != "matchformer":
        return
    scene = tmp_path / "scene"
    chip_smoke.write_scene(str(scene), size=128, n_views=3)
    out = tmp_path / "served"
    rc = cli.main(["reconstruct", "--scene", str(scene), "--output",
                   str(out), "--device", "cpu", "--img-resize", "96",
                   "--matcher-arch", "matchformer", "--matcher-ckpt", path,
                   "--refine-iters", "0"])
    (_key, engine), = pipeline._ENGINE_CACHE.items()
    pipeline._ENGINE_CACHE.clear()
    assert type(engine.model).__name__ == "MatchFormerMatcher"
    assert rc in (0, 1) and pipeline.matches_stored(str(out))
