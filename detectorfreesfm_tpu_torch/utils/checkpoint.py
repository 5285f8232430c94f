"""Flax msgpack checkpoints -> the port's state_dicts.

Counterpart of the JAX package's train/selfsup.py `load_matcher_params` and
train/refiner_selfsup.py `load_refiner_params`.
The checkpoint is decoded with the pure-Python utils/msgpack_lite.py, and
each flax leaf maps by name onto the port's module tree:

  conv `kernel` (kh, kw, in, out)  -> `weight` (out, in, kh, kw)
  dense `kernel` (in, out)         -> `weight` (out, in)
  `scale` (BatchNorm, LayerNorm)   -> `weight`
  `bias`                           -> `bias`
  batch_stats `mean` / `var`       -> `running_mean` / `running_var`

Every tensor is cast to float32, as the JAX loader casts to its fp32
template. Conversion is strict: an unused leaf or a parameter left unfilled
raises. The one exception is the JAX loader's: a coarse-only checkpoint
(no `fine_match` subtree, as the r2 and self-supervised ones) fills every
other parameter strictly, and the fine head keeps a seeded random init.
The port's model always builds its fine head and leaves it unused when
`fine_enabled` is off (flax creates no parameters for it then).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
from torch import nn

from .msgpack_lite import msgpack_restore

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()) -> Iterator[Tuple[tuple, object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert_leaf(collection: str, path: tuple, value: torch.Tensor):
    *mods, leaf = path
    if collection == "batch_stats":
        if leaf not in _STAT_NAMES:
            raise ValueError(f"unexpected batch_stats leaf {'/'.join(path)}")
        return ".".join(mods + [_STAT_NAMES[leaf]]), value
    if leaf == "kernel" and value.dim() == 4:
        return ".".join(mods + ["weight"]), value.permute(3, 2, 0, 1)
    if leaf == "kernel" and value.dim() == 2:
        return ".".join(mods + ["weight"]), value.t()
    if leaf == "scale":
        return ".".join(mods + ["weight"]), value
    if leaf == "bias":
        return ".".join(mods + ["bias"]), value
    raise ValueError(f"unexpected parameter leaf {'/'.join(path)}")


def flax_variables_to_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} flax tree -> fp32 state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unexpected variable collection {collection!r}")
        for path, value in _leaves(tree):
            name, tensor = _convert_leaf(collection, path, value)
            if name in out:
                raise ValueError(f"two checkpoint leaves map onto {name}")
            out[name] = tensor.float().contiguous()
    return out


def read_variables(path: str) -> dict:
    """The flax variables of a checkpoint saved as {params: vars[, step]}."""
    with open(path, "rb") as f:
        raw = msgpack_restore(f.read())
    return raw.get("params", raw)


def match_state_dict(state: Dict[str, torch.Tensor],
                     expected: Dict[str, torch.Tensor]):
    """Raise unless `state` fills every entry of `expected` with the same
    shape and has nothing else."""
    unused = sorted(set(state) - set(expected))
    missing = sorted(set(expected) - set(state))
    bad = sorted(n for n in set(state) & set(expected)
                 if tuple(state[n].shape) != tuple(expected[n].shape))
    if unused or missing or bad:
        raise ValueError(
            f"checkpoint does not fit the model: {len(unused)} unused leaves "
            f"{unused[:4]}, {len(missing)} missing parameters {missing[:4]}, "
            f"{len(bad)} shape mismatches {bad[:4]}")


FINE_PREFIX = "fine_match."


def fresh_fine_head(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A random fine head (`fine_match.*`) drawn from an explicit
    torch.Generator: torch's default Linear init (kaiming-uniform weights,
    uniform biases) and LayerNorm init (ones, zeros)."""
    from ..models.loftr import FinePreprocessAndMatch

    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        head = FinePreprocessAndMatch(cfg)
    out = {}
    for name, mod in head.named_modules():
        if isinstance(mod, nn.Linear):
            w = torch.empty(mod.weight.shape)
            nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=gen)
            out[f"{name}.weight"] = w
            if mod.bias is not None:
                bound = 1.0 / math.sqrt(mod.in_features)
                out[f"{name}.bias"] = torch.empty(mod.bias.shape).uniform_(
                    -bound, bound, generator=gen)
        elif isinstance(mod, nn.LayerNorm):
            out[f"{name}.weight"] = torch.ones(mod.weight.shape)
            out[f"{name}.bias"] = torch.zeros(mod.bias.shape)
    return {FINE_PREFIX + k: v for k, v in out.items()}


def load_matcher_params(path: str, cfg=None) -> Dict[str, torch.Tensor]:
    """The port's DetectorFreeMatcher state_dict from a flax checkpoint.

    A checkpoint without the fine head loads strictly into everything else;
    the head comes from `fresh_fine_head(cfg)`, and when `cfg` enables the
    fine stage the same warning as the JAX loader's is printed."""
    from ..models.loftr import DetectorFreeMatcher, MatcherConfig

    cfg = cfg or MatcherConfig()
    state = flax_variables_to_state_dict(read_variables(path))
    with torch.device("meta"):
        template = DetectorFreeMatcher(cfg).state_dict()
    if any(k.startswith(FINE_PREFIX) for k in state):
        match_state_dict(state, template)
        return state
    match_state_dict(state, {k: v for k, v in template.items()
                             if not k.startswith(FINE_PREFIX)})
    if cfg.fine_enabled:
        missing = ["/params/fine_match"]
        print(f"warning: checkpoint {path} lacks {len(missing)} subtrees "
              f"(kept at random init): {missing[:4]}")
    state.update(fresh_fine_head(cfg))
    return state


def load_refiner_params(path: str, cfg=None, device=None
                        ) -> Dict[str, torch.Tensor]:
    """The port's MultiviewRefiner state_dict from a flax checkpoint, on
    `device` (None: CUDA, and raises without it). Strict: every leaf is
    used and every parameter filled, with the shapes of `cfg`."""
    from ..device import resolve_device
    from ..models.multiview_matcher import MultiviewRefiner, RefinerConfig

    dev = resolve_device(device)
    state = flax_variables_to_state_dict(read_variables(path))
    with torch.device("meta"):
        template = MultiviewRefiner(cfg or RefinerConfig()).state_dict()
    match_state_dict(state, template)
    return {k: v.to(dev) for k, v in state.items()}
