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
