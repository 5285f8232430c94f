"""The port's msgpack decoder and flax->torch weight converter against the
JAX side (flax.serialization and train/selfsup.load_matcher_params)."""

import os

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from detectorfreesfm_tpu_torch.utils import checkpoint, msgpack_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATCHER = os.path.join(REPO, "weights", "demo_matcher_r5_bf16.msgpack")
REFINER = os.path.join(REPO, "weights", "demo_refiner_r4_bf16.msgpack")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _bits(x):
    """Raw bytes of an array or tensor leaf, with its shape and dtype name."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        raw = x.contiguous().view(torch.uint8).numpy().tobytes()
        return tuple(x.shape), name, raw
    x = np.asarray(x)
    return x.shape, x.dtype.name, x.tobytes()


@pytest.mark.parametrize("path", [MATCHER, REFINER],
                         ids=["matcher_r5", "refiner_r4"])
def test_decoder_equals_flax_msgpack_restore(path):
    """Same tree, same leaves, bit for bit (bf16 included)."""
    with open(path, "rb") as f:
        blob = f.read()
    ref = dict(_leaves(serialization.msgpack_restore(blob)))
    ours = dict(_leaves(msgpack_lite.msgpack_restore(blob)))
    assert ours.keys() == ref.keys()
    n_arrays = 0
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            n_arrays += 1
            assert _bits(ours[k]) == _bits(v), k
        else:
            assert ours[k] == v, k
    assert n_arrays > 50


@pytest.mark.parametrize("obj", [
    {"a": 1, "b": -1, "c": -33, "d": 2 ** 40, "e": -(2 ** 40), "f": 255,
     "g": 65536, "h": -200},
    [1.5, -2.25, 1e300, True, False, None, "x" * 40, "y" * 300],
    {"nested": {"k": [b"\x00\x01", b"z" * 70000]}, "s": "é"},
    list(range(20)) + [{str(i): i for i in range(20)}],
], ids=["ints", "floats_str", "bin_nested", "array16_map16"])
def test_decoder_equals_msgpack_on_plain_types(obj):
    blob = msgpack.packb(obj, use_bin_type=True)
    ref = msgpack.unpackb(blob, raw=False)
    assert msgpack_lite.msgpack_restore(blob) == ref


def test_decoder_rejects_trailing_and_truncated_data():
    blob = msgpack.packb({"a": [1, 2, 3]}, use_bin_type=True)
    with pytest.raises(ValueError):
        msgpack_lite.msgpack_restore(blob + b"\x00")
    with pytest.raises(ValueError):
        msgpack_lite.msgpack_restore(blob[:-1])


@pytest.fixture(scope="module")
def jax_params():
    from detectorfreesfm_tpu.models.loftr import MatcherConfig
    from detectorfreesfm_tpu.train.selfsup import load_matcher_params

    return load_matcher_params(MATCHER, img_size=64,
                               cfg=MatcherConfig(fine_enabled=True))


def test_converter_fills_every_tensor_once(jax_params):
    """Every r5 leaf maps onto exactly one parameter or buffer of the
    port's model, and equals the JAX loader's fp32 value, transposed."""
    from detectorfreesfm_tpu_torch.models.loftr import (
        DetectorFreeMatcher,
        MatcherConfig,
    )

    state = checkpoint.load_matcher_params(MATCHER)
    model_keys = set(DetectorFreeMatcher(MatcherConfig()).state_dict())
    assert set(state) == model_keys
    n_params = sum(v.numel() for k, v in state.items()
                   if not k.endswith(("running_mean", "running_var")))
    n_stats = sum(v.numel() for k, v in state.items()
                  if k.endswith(("running_mean", "running_var")))
    assert (n_params, n_stats) == (11265288, 6584)
    assert all(v.dtype == torch.float32 for v in state.values())

    n_leaves = 0
    for coll, tree in jax_params.items():
        for path, value in _leaves(tree):
            v = np.asarray(value)
            name, _ = checkpoint._convert_leaf(coll, path,
                                               torch.zeros(v.shape))
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            elif v.ndim == 2:
                v = v.T
            np.testing.assert_array_equal(state[name].numpy(), v, err_msg=name)
            n_leaves += 1
    assert n_leaves == len(state)


def test_converter_rejects_unused_and_missing_leaves():
    variables = checkpoint.read_variables(MATCHER)
    variables["params"]["backbone"]["extra"] = {"kernel": torch.zeros(3, 3)}
    with pytest.raises(ValueError, match="1 unused"):
        checkpoint.match_state_dict(
            checkpoint.flax_variables_to_state_dict(variables),
            checkpoint.flax_variables_to_state_dict(
                checkpoint.read_variables(MATCHER)))
    variables = checkpoint.read_variables(MATCHER)
    del variables["batch_stats"]["backbone"]["bn1"]["var"]
    state = checkpoint.flax_variables_to_state_dict(variables)
    full = checkpoint.flax_variables_to_state_dict(
        checkpoint.read_variables(MATCHER))
    with pytest.raises(ValueError, match="1 missing"):
        checkpoint.match_state_dict(state, full)
    with pytest.raises(ValueError, match="unexpected parameter leaf"):
        checkpoint.flax_variables_to_state_dict(
            {"params": {"m": {"weird": torch.zeros(2)}}})


# --- coarse-only checkpoints (r2, selfsup) ----------------------------------

R2 = os.path.join(REPO, "weights", "demo_matcher_r2_bf16.msgpack")
SELFSUP = os.path.join(REPO, "weights", "demo_selfsup_bf16.msgpack")


@pytest.mark.parametrize("path", [R2, SELFSUP], ids=["r2", "selfsup"])
def test_coarse_only_checkpoint_loads_coarse_only(path, capsys):
    """With fine_enabled=False the port loads the checkpoint strictly into
    backbone and coarse_transformer, each leaf equal to the JAX loader's
    fp32 value; the unused fine head is filled from the seeded init, the
    model loads the state strictly, and nothing is printed (JAX prints
    nothing either)."""
    from detectorfreesfm_tpu.models.loftr import MatcherConfig as JaxCfg
    from detectorfreesfm_tpu.train.selfsup import load_matcher_params as jl
    from detectorfreesfm_tpu_torch.models.loftr import (
        DetectorFreeMatcher,
        MatcherConfig,
    )

    ref = jl(path, img_size=64, cfg=JaxCfg(fine_enabled=False))
    assert sorted(ref["params"]) == ["backbone", "coarse_transformer"]
    capsys.readouterr()
    state = checkpoint.load_matcher_params(path, MatcherConfig())
    assert capsys.readouterr().out == ""
    n = 0
    for coll, tree in ref.items():
        for leaf_path, value in _leaves(tree):
            v = np.asarray(value)
            name, _ = checkpoint._convert_leaf(coll, leaf_path,
                                               torch.zeros(v.shape))
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            elif v.ndim == 2:
                v = v.T
            np.testing.assert_array_equal(state[name].numpy(), v,
                                          err_msg=name)
            n += 1
    fine = [k for k in state if k.startswith("fine_match.")]
    assert n + len(fine) == len(state) and len(fine) == 26
    DetectorFreeMatcher(MatcherConfig()).load_state_dict(state)
    again = checkpoint.load_matcher_params(path, MatcherConfig())
    for k in fine:  # the seeded init is reproducible
        assert torch.equal(again[k], state[k])


@pytest.mark.parametrize("path", [R2, SELFSUP], ids=["r2", "selfsup"])
def test_fine_enabled_load_of_coarse_only_checkpoint_warns_as_jax(path,
                                                                  capsys):
    """fine_enabled=True with a checkpoint that lacks the fine head: the
    same warning line as the JAX loader's, and a complete state whose fine
    head is the seeded init (strictness is kept for every other leaf)."""
    from detectorfreesfm_tpu.models.loftr import MatcherConfig as JaxCfg
    from detectorfreesfm_tpu.train.selfsup import load_matcher_params as jl
    from detectorfreesfm_tpu_torch.models.loftr import (
        DetectorFreeMatcher,
        MatcherConfig,
    )

    capsys.readouterr()
    jl(path, img_size=64, cfg=JaxCfg(fine_enabled=True))
    want = capsys.readouterr().out
    cfg = MatcherConfig(fine_enabled=True)
    state = checkpoint.load_matcher_params(path, cfg)
    got = capsys.readouterr().out
    assert want.startswith("warning: checkpoint") and got == want
    DetectorFreeMatcher(cfg).load_state_dict(state)
    fresh = checkpoint.fresh_fine_head(cfg)
    assert all(torch.equal(state[k], v) for k, v in fresh.items())
    other = checkpoint.fresh_fine_head(cfg, seed=1)
    assert not all(torch.equal(other[k], v) for k, v in fresh.items())


def test_full_checkpoints_still_load_strictly():
    """r3 and r5 keep their fine heads (nothing from the seeded init), and
    a missing coarse leaf still raises."""
    from detectorfreesfm_tpu_torch.models.loftr import MatcherConfig

    cfg = MatcherConfig(fine_enabled=True)
    for name in ("demo_matcher_r3_bf16", "demo_matcher_r5_bf16"):
        path = os.path.join(REPO, "weights", f"{name}.msgpack")
        state = checkpoint.load_matcher_params(path, cfg)
        raw = checkpoint.flax_variables_to_state_dict(
            checkpoint.read_variables(path))
        assert state.keys() == raw.keys()
        assert all(torch.equal(state[k], raw[k]) for k in raw)
    variables = checkpoint.read_variables(R2)
    del variables["params"]["backbone"]["conv1"]
    state = checkpoint.flax_variables_to_state_dict(variables)
    from detectorfreesfm_tpu_torch.models.loftr import DetectorFreeMatcher

    with torch.device("meta"):
        template = DetectorFreeMatcher(cfg).state_dict()
    with pytest.raises(ValueError, match="missing"):
        checkpoint.match_state_dict(
            state, {k: v for k, v in template.items()
                    if not k.startswith("fine_match.")})


def test_r2_coarse_matches_equal_jax_engine():
    """The coarse-only engine (fine_enabled=False) with the r2 weights gives
    the JAX engine's matches on a small synthetic scene: the same match
    rows on every pair (IoU >= 0.95, as the r5 engine test)."""
    import jax

    from detectorfreesfm_tpu.data.images import LoadedImage as JaxImage
    from detectorfreesfm_tpu.match.engine import (
        EngineConfig as JaxEngineConfig,
        PairMatchingEngine as JaxEngine,
    )
    from detectorfreesfm_tpu.models.loftr import MatcherConfig as JaxCfg
    from detectorfreesfm_tpu.parallel.mesh import make_mesh
    from detectorfreesfm_tpu.train.selfsup import load_matcher_params as jl
    from detectorfreesfm_tpu_torch.data.images import from_array
    from detectorfreesfm_tpu_torch.data.synthetic import (
        SyntheticConfig,
        generate_scene,
    )
    from detectorfreesfm_tpu_torch.match.engine import (
        EngineConfig,
        PairMatchingEngine,
    )
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs

    size = 128
    images, *_ = generate_scene(1, SyntheticConfig(size=size, n_views=3))
    names = [f"v{i}" for i in range(3)]
    pairs = exhaustive_pairs(names)
    jparams = jl(R2, img_size=size, cfg=JaxCfg(fine_enabled=False))
    jeng = JaxEngine(JaxEngineConfig(img_resize=size, fine_enabled=False,
                                     round_matches_ratio=4, batch_size=1),
                     params=jparams,
                     mesh=make_mesh(1, devices=jax.devices()[:1]))
    ref = jeng.match_pairs(pairs, {
        n: JaxImage(images[i], np.ones(2, np.float32), (size, size),
                    (size, size)) for i, n in enumerate(names)})
    cfg = EngineConfig(img_resize=size, fine_enabled=False,
                       round_matches_ratio=4, batch_size=1)
    peng = PairMatchingEngine(
        cfg, checkpoint.load_matcher_params(R2, cfg.matcher_config()),
        device="cpu")
    got = peng.match_pairs(pairs, {n: from_array(images[i])
                                   for i, n in enumerate(names)})

    def rows(m):
        return {tuple(r) for r in np.concatenate(
            [np.asarray(m["kpts0"]), np.asarray(m["kpts1"])], 1).tolist()}

    for p in pairs:
        a, b = rows(ref[p]), rows(got[p])
        assert len(a) > 10, (p, len(a))
        assert len(a & b) / len(a | b) >= 0.95, p
