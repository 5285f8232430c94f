"""The port's ASpan matcher (models/aspan.py), `build_matcher` and the
arch-aware checkpoint loader against the JAX package on the CPU.

Inputs come from numpy seeds; weights from a JAX init (or the bundled
ASpan file), carried across with utils/checkpoint.py's conversion.

fp32 tolerances: FlowHead's flow within 2e-5 cells; FlowCrossAttention,
fed JAX's own flow, within 1e-5 of its output's largest value; the whole
matcher (bundled weights, 128 px pair) by its match set, IoU >= 0.99 with
the same valid count within 1%, and its dense confidence within 1e-4
of its largest value. The window is discrete (a flow one ulp from JAX's can move a
window cell), so the whole model is held by these bounds and not element
by element. One training step: loss 1e-5 and gradient norm 1e-4
relative. bf16: the criteria of tests/test_torch_bf16.py (bf16_errors),
and match sets at the IoU floor stated in the test.

JAX functions run with test_torch_bf16's XLA CPU options (JAX_BF16).
"""

import dataclasses
import functools
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
import optax  # noqa: E402

from detectorfreesfm_tpu.models import aspan as jax_aspan  # noqa: E402
from detectorfreesfm_tpu.models import build_matcher as jax_build  # noqa
from detectorfreesfm_tpu_torch.models import aspan  # noqa: E402
from detectorfreesfm_tpu_torch.models import build_matcher  # noqa: E402
from detectorfreesfm_tpu_torch.utils import checkpoint  # noqa: E402
from test_torch_bf16 import bf16_errors, jax_tree_fp32, jjit  # noqa: E402
from test_torch_train import state_of, t2n  # noqa: E402

ASPAN = os.path.join(REPO, "weights", "demo_aspan_bf16.msgpack")
R5 = os.path.join(REPO, "weights", "demo_matcher_r5_bf16.msgpack")
DTYPES = ("float32", "bfloat16")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs this file beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(seed, b=2, l=96, c=256):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, l, c)).astype(np.float32) for _ in "xs"]


def _port(module, variables):
    module.load_state_dict(state_of(variables))
    return module.eval()


def _run_both(jmod, tmod, variables, args, dtype):
    """(JAX output, port output) of one module in one dtype."""
    ref = jjit(jmod.apply)(variables, *map(jnp.asarray, args[:2]),
                           *args[2:])
    with torch.no_grad():
        ours = _port(tmod, variables)(*(torch.from_numpy(np.asarray(a))
                                        for a in args[:2]), *args[2:])
    return np.asarray(ref, np.float32), ours


HW = (8, 12)  # the 96-cell grid of _tokens


@pytest.fixture(scope="module")
def flow_head_vars():
    x, s = _tokens(0)
    return jax.jit(lambda k: jax_aspan.FlowHead().init(k, x, s, HW))(
        jax.random.PRNGKey(1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flow_head_matches_jax(flow_head_vars, dtype):
    """(2, 96) queries on an 8 x 12 grid. bf16: (2.5e-7, 1.1e-3,
    1.1e-3)."""
    x, s = _tokens(0)
    out = {}
    for dt in DTYPES:
        out[dt] = _run_both(jax_aspan.FlowHead(JAX_DT[dt]),
                            aspan.FlowHead(256, TORCH_DT[dt]),
                            flow_head_vars, (x, s, HW), dt)
    ref, ours = out[dtype]
    assert ours.dtype == torch.float32 and ours.shape == (2, 96, 2)
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2e-5)
    else:
        bf16_errors(ours, ref, out["float32"][0], out["float32"][1])


@pytest.fixture(scope="module")
def cross_case(flow_head_vars):
    """Inputs, JAX's own fp32 flow for them (with cells pushed past the
    grid's edges) and a JAX init of FlowCrossAttention."""
    x, s = _tokens(2)
    flow = np.asarray(jax_aspan.FlowHead().apply(flow_head_vars, x, s, HW))
    flow = flow.copy()
    flow[:, :6] += np.float32(9.0)  # windows clipped at the far edge
    mod = jax_aspan.FlowCrossAttention(256, 8, 2)
    variables = jax.jit(lambda k: mod.init(k, x, s, HW, flow))(
        jax.random.PRNGKey(3))
    return x, s, flow, variables


def _jax_window_cells(flow, hw, r=2):
    """JAX's window index computation (models/aspan.py), in jnp."""
    b, l, _ = flow.shape
    h, w = hw
    cols = jnp.arange(l, dtype=jnp.float32) % w
    rows = jnp.arange(l, dtype=jnp.float32) // w
    cx = jnp.clip(cols[None] + flow[..., 0], 0, w - 1)
    cy = jnp.clip(rows[None] + flow[..., 1], 0, h - 1)
    offs = jnp.arange(-r, r + 1, dtype=jnp.float32)
    gx = jnp.clip(jnp.round(cx[..., None, None] + offs[None, None, None]),
                  0, w - 1)
    gy = jnp.clip(jnp.round(cy[..., None, None]
                            + offs[None, None, :, None]), 0, h - 1)
    return np.asarray((gy * w + gx).astype(jnp.int32).reshape(b, l, -1))


def test_window_cells_equal_jax(cross_case):
    """The discrete windows on JAX's flow, and on flows at exact halves
    (round half to even in both) and past the grid: the same cells."""
    _x, _s, flow, _v = cross_case
    halves = np.round(flow * 2.0) / 2.0
    mod = aspan.FlowCrossAttention(256, 8, 2)
    for f in (flow, halves.astype(np.float32)):
        ours = mod.window_cells(torch.from_numpy(f), HW).numpy()
        assert (ours == _jax_window_cells(jnp.asarray(f), HW)).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_flow_cross_attention_on_jax_flow(cross_case, dtype):
    """Both packages fed the same (JAX fp32) flow. bf16: (5.8e-4, 3.9e-3,
    3.9e-3)."""
    x, s, flow, variables = cross_case
    out = {}
    for dt in DTYPES:
        # The tokens in the run's dtype, as the matcher's stream carries
        # them.
        jx, js = (jnp.asarray(a, JAX_DT[dt]) for a in (x, s))
        tx, ts = (torch.from_numpy(a).to(TORCH_DT[dt]) for a in (x, s))
        jmod = jax_aspan.FlowCrossAttention(256, 8, 2, JAX_DT[dt])
        ref = jjit(jmod.apply, static_argnums=3)(variables, jx, js, HW, flow)
        with torch.no_grad():
            ours = _port(aspan.FlowCrossAttention(256, 8, 2, TORCH_DT[dt]),
                         variables)(tx, ts, HW, torch.from_numpy(flow))
        assert ours.dtype == TORCH_DT[dt] and ref.dtype == JAX_DT[dt]
        out[dt] = (np.asarray(ref, np.float32), ours)
    ref, ours = out[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    else:
        bf16_errors(ours, ref, out["float32"][0], out["float32"][1])


# --- the whole matcher, bundled weights --------------------------------------


def _scene_pair(size, seed=0):
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)

    imgs = generate_scene(seed, SyntheticConfig(size=size, n_views=2))[0]
    return imgs[0:1, ..., None], imgs[1:2, ..., None]


def match_rows(out, b=0):
    v = np.asarray(out.valid[b])
    return set(zip(map(tuple, np.asarray(out.coords0[b])[v].tolist()),
                   map(tuple, np.asarray(out.coords1[b])[v].tolist())))


def matcher_runs(arch, variables, port_state, size, seed=0,
                 self_pair=False, **kw):
    """JAX and the port (built with `kw`) on one synthetic pair at `size`
    px with a live region narrower than the frame, in both dtypes:
    {(who, dtype): (MatchOutput, conf)}. With `self_pair` a second pair
    in the batch matches image0 with itself."""
    img0, img1 = _scene_pair(size, seed)
    hw = np.array([[size, size - 8]], np.int32)
    if self_pair:
        img0, img1 = np.concatenate([img0, img0]), np.concatenate([img1,
                                                                   img0])
        hw = np.concatenate([hw, hw])
    runs = {}
    for dt in DTYPES:
        jm = jax_build(arch, compute_dtype=dt, **kw)
        runs["jax", dt] = jjit(functools.partial(jm.apply, return_conf=True))(
            variables, jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(hw),
            jnp.asarray(hw))
        tm = build_matcher(arch, compute_dtype=dt, **kw).eval()
        tm.load_state_dict(port_state)
        with torch.no_grad():
            runs["port", dt] = tm(*map(torch.from_numpy,
                                       (img0, img1, hw, hw)),
                                  return_conf=True)
    return runs


def check_matcher_runs(runs, iou_floor_bf16, n_min, b=0, gap=1.0):
    """fp32: pair b's match sets at IoU >= 0.99, valid counts within 1%,
    the dense conf within 1e-4 of its largest value; bf16: IoU against
    JAX bf16 >= iou_floor_bf16 and the dense conf by bf16_errors (with
    its `gap`). Returns the IoUs found."""
    sets = {k: match_rows(v[0], b) for k, v in runs.items()}

    def iou(a, b):
        return len(sets[a] & sets[b]) / max(len(sets[a] | sets[b]), 1)

    j32 = ("jax", "float32")
    assert len(sets[j32]) >= n_min
    ious = dict(fp32=iou(("port", "float32"), j32),
                bf16=iou(("port", "bfloat16"), ("jax", "bfloat16")),
                jax_bf16_fp32=iou(("jax", "bfloat16"), j32))
    print("IoU", ious, {k: len(v) for k, v in sets.items()})
    assert ious["fp32"] >= 0.99, ious
    assert abs(len(sets["port", "float32"]) - len(sets[j32])) <= 0.01 * len(
        sets[j32])
    c32, r32 = runs["port", "float32"][1].numpy(), np.asarray(runs[j32][1])
    assert np.abs(c32 - r32).max() <= 1e-4 * r32.max()
    assert ious["bf16"] >= iou_floor_bf16, ious
    assert runs["port", "bfloat16"][1].dtype == torch.float32
    bf16_errors(runs["port", "bfloat16"][1], runs["jax", "bfloat16"][1],
                runs[j32][1], runs["port", "float32"][1], gap=gap)
    return ious


def test_aspan_matcher_matches_jax():
    """The bundled ASpan weights at 128 px (16 x 16 cells): fp32 IoU 1.0;
    bf16 IoU 0.988 against JAX bf16 (JAX bf16 against JAX fp32: 0.988),
    held at >= 0.9; the dense conf (1.3e-2, 1.5e-2, 1.5e-2)."""
    variables = jax_tree_fp32(ASPAN)
    runs = matcher_runs("aspan", variables, checkpoint.load_arch_params(
        ASPAN, "aspan"), 128)
    check_matcher_runs(runs, iou_floor_bf16=0.9, n_min=40)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_then_match_views_equals_forward(dtype):
    """The per-image stage (`encode_views`) of both frames, then the pair
    stage (`match_views`) on their CoarseViews, give `forward`'s matches
    and dense confidence bit for bit (bundled weights, a 96 px pair with
    a narrower live region)."""
    img0, img1 = (torch.from_numpy(x) for x in _scene_pair(96))
    hw = torch.tensor([[96, 88]])
    m = build_matcher("aspan", compute_dtype=dtype).eval()
    m.load_state_dict(checkpoint.load_arch_params(ASPAN, "aspan"))
    with torch.no_grad():
        want, want_conf = m(img0, img1, hw, hw, return_conf=True)
        views = m.encode_views(torch.cat([img0, img1]))
        assert views.coarse.shape == (2, 12, 12, 256)
        assert views.coarse.dtype == TORCH_DT[dtype]
        got, conf = m.match_views(aspan.CoarseViews(views.coarse[:1]),
                                  aspan.CoarseViews(views.coarse[1:]), hw,
                                  hw, return_conf=True)
    assert int(want.valid.sum()) > 10
    for g, w in zip(got + (conf,), want + (want_conf,)):
        assert torch.equal(g, w)


# --- the checkpoint loader and build_matcher ---------------------------------


def test_bundled_aspan_loads_strictly():
    """weights/demo_aspan_bf16.msgpack: 16 464 664 parameters and 6 584
    BatchNorm statistics, fp32, every leaf used; read as another family
    (or another family's file read as ASpan) it raises."""
    state = checkpoint.load_arch_params(ASPAN, "aspan")
    stats = ("running_mean", "running_var")
    assert sum(v.numel() for k, v in state.items()
               if not k.endswith(stats)) == 16464664
    assert sum(v.numel() for k, v in state.items()
               if k.endswith(stats)) == 6584
    assert all(v.dtype == torch.float32 for v in state.values())
    model = build_matcher("aspanformer")
    model.load_state_dict(state)  # strict
    with pytest.raises(ValueError, match="does not fit"):
        checkpoint.load_arch_params(ASPAN, "matchformer")
    with pytest.raises(ValueError, match="does not fit"):
        checkpoint.load_arch_params(R5, "aspan")


def _config_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", ["loftr", "loftr_official", "detectorfree",
                                  "LoFTR", "aspan", "aspanformer",
                                  "matchformer"])
def test_build_matcher_names_equal_jax(name):
    """Each name and alias gives the JAX factory's family, with the
    overrides applied to the same config; every field JAX's config has
    holds JAX's value."""
    kw = dict(match_threshold=0.3, max_matches=64, compute_dtype="bfloat16")
    with torch.device("meta"):
        ours = build_matcher(name, **kw)
    ref = jax_build(name, **kw)
    assert type(ours).__name__ == type(ref).__name__
    assert type(ours.cfg).__name__ == type(ref.cfg).__name__
    j, t = _config_fields(ref.cfg), _config_fields(ours.cfg)
    assert {k: t[k] for k in j if k in t} == {
        k: tuple(v) if isinstance(v, list) else v for k, v in j.items()
        if k in t}
    assert set(j) - set(t) <= {"dsm_tile_l", "dsm_tile_s"}
    assert ours.cfg.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["superglue", "aspan2", ""])
def test_build_matcher_unknown_name_raises(name):
    with pytest.raises(ValueError, match="unknown matcher"):
        jax_build(name)
    with pytest.raises(ValueError, match="unknown matcher"):
        build_matcher(name)
    from detectorfreesfm_tpu_torch.match.engine import EngineConfig

    with pytest.raises(ValueError, match="unknown matcher"):
        EngineConfig(matcher=name)


# --- one training step -------------------------------------------------------


def alt_trainers(arch, dtype, params=None, **model_kw):
    """JAX's and the port's MatcherTrainer for `arch` on 64 px pairs, the
    model cut by `model_kw` in both (the trainers build the full-depth
    model; JAX compiles its gradient for minutes), with JAX's init (or
    `params`, one for both dtypes: flax keeps fp32 parameters) carried
    across."""
    from detectorfreesfm_tpu.models.loftr import MatcherConfig as JC
    from detectorfreesfm_tpu.train.matcher_trainer import (
        MatcherTrainConfig as JMC, MatcherTrainer as JMT, MatcherTrainState)
    from detectorfreesfm_tpu.train.optimizers import OptimConfig as JOC
    from detectorfreesfm_tpu.train.optimizers import build_optimizer
    from detectorfreesfm_tpu_torch.models.loftr import MatcherConfig
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        MatcherTrainConfig, MatcherTrainer)
    from detectorfreesfm_tpu_torch.train.optimizers import OptimConfig

    kw = dict(max_matches=32, compute_dtype=dtype)
    jt = JMT(JMC(arch=arch, matcher=JC(**kw), optim=JOC(
        canonical_lr=5e-4, true_batch_size=2, milestones=(1000,))))
    assert type(jt.model).__name__ == {
        "aspan": "ASpanMatcher", "matchformer": "MatchFormerMatcher"}[arch]
    jt.model = jax_build(arch, border=1, **kw, **model_kw)
    if params is None:
        img = jnp.zeros((1, 64, 64, 1))
        params = jax.jit(jt.model.init)(jax.random.PRNGKey(jt.cfg.seed), img,
                                        img)
    jt.tx = build_optimizer(jt.cfg.optim, params)
    jstate = MatcherTrainState(params, jt.tx.init(params),
                               jnp.zeros((), jnp.int32))
    tt = MatcherTrainer(MatcherTrainConfig(
        arch=arch, matcher=MatcherConfig(**kw), optim=OptimConfig(
            canonical_lr=5e-4, true_batch_size=2, milestones=(1000,))),
        device="cpu")
    assert type(tt.model).__name__ == type(jt.model).__name__
    tt.model = build_matcher(arch, border=1, **kw, **model_kw)
    tstate = tt.init_state()
    assert set(tstate.params) == set(state_of(jstate.params))
    return jt, jstate, tt, tstate._replace(params=state_of(jstate.params))


def alt_train_step_runs(arch, **model_kw):
    """One step on the same pairs, labels and parameters, in both dtypes:
    {dtype: losses and gradient norms}, and in fp32 the parameters after
    the step."""
    from test_torch_train_matcher import pair_batch

    batch = pair_batch()
    out, params = {}, None
    for dt in DTYPES:
        jt, jstate, tt, tstate = alt_trainers(arch, dt, params, **model_kw)
        params = jstate.params
        gt, uv1 = jt._supervise(batch)
        assert (t2n(tt.supervise(batch)[0]) == gt).all()

        def loss_fn(p):
            return jnp.mean(jax.vmap(lambda a, b, g, u: jt._loss_one(
                p, a, b, g, u))(jnp.asarray(batch["image0"]),
                                jnp.asarray(batch["image1"]),
                                jnp.asarray(gt), jnp.asarray(uv1)))

        jl, jgrad = jjit(jax.value_and_grad(loss_fn))(jstate.params)
        # The step's loss and gradient norm, as the trainer logs them.
        state2, tl = tt.train_step(tstate, batch)
        out[dt] = dict(jl=float(jl), tl=float(tl),
                       jn=float(optax.global_norm(jgrad)),
                       tn=tt.history[0]["grad_norm"])
        if dt == "float32":
            upd, _ = jt.tx.update(jgrad, jstate.opt_state, jstate.params)
            out[dt].update(tparams=state2.params, jparams=state_of(
                optax.apply_updates(jstate.params, upd)))
    return out


def check_alt_train_step(out, dtype):
    """fp32: loss 1e-5 and gradient norm 1e-4 relative, the parameters
    after Adam's step as test_torch_train's assert_adam_step_close; bf16:
    both scalars by bf16_errors."""
    from test_torch_train import assert_adam_step_close

    o, r = out[dtype], out["float32"]
    print(dtype, "loss", o["tl"], o["jl"], "grad norm", o["tn"], o["jn"])
    if dtype == "float32":
        np.testing.assert_allclose(o["tl"], o["jl"], rtol=1e-5)
        np.testing.assert_allclose(o["tn"], o["jn"], rtol=1e-4)
        assert_adam_step_close(o["tparams"], o["jparams"], 5e-4 * 2 / 4)
    else:
        bf16_errors(o["tl"], o["jl"], r["jl"], r["tl"])
        bf16_errors(o["tn"], o["jn"], r["jn"], r["tn"])


@pytest.fixture(scope="module")
def aspan_step():
    return alt_train_step_runs("aspan", n_flow_layers=1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_aspan_train_step_equals_jax(aspan_step, dtype):
    """ASpan with one flow round, 64 px planar pairs. bf16: the loss
    (4.4e-6, 3.8e-5, 3.4e-5), the gradient norm (1.6e-3, 2.5e-3,
    9.3e-4)."""
    check_alt_train_step(aspan_step, dtype)


def test_alt_arch_with_fine_stage_raises():
    """JAX's trainer fails at its first step with an alt arch and the fine
    stage (the model takes no `fine_at`); the port refuses the config
    when it is constructed."""
    from detectorfreesfm_tpu_torch.models.loftr import MatcherConfig
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        MatcherTrainConfig, MatcherTrainer)

    for arch in ("aspan", "matchformer"):
        with pytest.raises(ValueError, match="no fine stage"):
            MatcherTrainer(MatcherTrainConfig(
                arch=arch, matcher=MatcherConfig(fine_enabled=True)),
                device="cpu")


def test_smoke_alt_train_gate():
    """chip_smoke's alt training gate passes JAX's own steps (ASpan's as
    recorded, MatchFormer's step-0 loss moved by 24%: other draws) and
    fails ASpan's step-0 loss or gradient norm or a later loss moved past
    its tolerance, a MatchFormer loss 26% away, or a non-finite one."""
    import copy

    import chip_smoke as cs

    ref = cs.JAX_TRAIN
    got = {a: dict(losses=list(ref[f"train_matcher_{a}"]["losses"]),
                   grad_norms=list(ref[f"train_matcher_{a}"]["grad_norms"]))
           for a in ("aspan", "matchformer")}
    ok = copy.deepcopy(got)
    ok["matchformer"]["losses"][0] *= 1.24
    cs._check_alt_train_gates(ok, ref)
    tol = cs.TRAIN_TOL
    for arch, key, i, factor in (
            ("aspan", "losses", 0, 1 + 1.5 * tol["loss0"]),
            ("aspan", "grad_norms", 0, 1 + 1.5 * tol["grad_norm0"]),
            ("aspan", "losses", 2, 1 - 1.5 * tol["later"]),
            ("matchformer", "losses", 0, 1.26),
            ("matchformer", "grad_norms", 1, float("nan"))):
        bad = copy.deepcopy(got)
        bad[arch][key][i] *= factor
        with pytest.raises(RuntimeError, match="chip_smoke check failed"):
            cs._check_alt_train_gates(bad, ref)
