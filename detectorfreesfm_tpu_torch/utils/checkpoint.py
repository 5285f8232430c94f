"""Flax msgpack checkpoints <-> the port's state_dicts.

Counterpart of the JAX package's train/selfsup.py `load_matcher_params`,
train/refiner_selfsup.py `load_refiner_params` and the JAX CLI's restore
of the other matcher families (`load_arch_params`), and of the trainers'
`serialization.to_bytes` writers (`save_checkpoint`, through
`state_dict_to_flax_variables`, the inverse map).
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

from .msgpack_lite import msgpack_restore, msgpack_serialize

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


def state_dict_to_flax_variables(state: Dict[str, torch.Tensor]) -> dict:
    """A state_dict -> the flax {"params": ..., "batch_stats": ...} tree:
    conv and dense weights transposed back to `kernel`, 1-d weights to
    `scale`, `running_mean`/`running_var` to batch_stats `mean`/`var`.
    Dtypes are kept."""
    out: dict = {}
    for name, t in state.items():
        *mods, leaf = name.split(".")
        t = t.detach()
        if leaf in ("running_mean", "running_var"):
            coll, key = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and t.dim() == 4:
            coll, key, t = "params", "kernel", t.permute(2, 3, 1, 0)
        elif leaf == "weight" and t.dim() == 2:
            coll, key, t = "params", "kernel", t.t()
        elif leaf == "weight" and t.dim() == 1:
            coll, key = "params", "scale"
        elif leaf == "bias":
            coll, key = "params", "bias"
        else:
            raise ValueError(f"no flax leaf for {name} {tuple(t.shape)}")
        node = out.setdefault(coll, {})
        for m in mods:
            node = node.setdefault(m, {})
        node[key] = t.contiguous()
    return out


def save_checkpoint(path: str, variables: dict, step=None) -> None:
    """Write `{"params": variables, "step": step}` (or `{"params":
    variables}` without a step), as the JAX trainers' and bootstraps'
    `serialization.to_bytes` does; JAX's loaders read the file."""
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tree = {"params": variables}
    if step is not None:
        tree["step"] = int(step)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))


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


# flax's lecun_normal: a normal truncated to +-2 std, scaled so that its
# std is sqrt(1 / fan_in) (the truncation's std is 0.8796...).
_TRUNC_STD = 0.87962566103423978


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise `module` in place as flax initialises the JAX package's
    models: Dense and Conv kernels lecun_normal, biases 0, LayerNorm and
    BatchNorm scales 1 and biases 0, BatchNorm statistics (0, 1). The
    draws come from `generator` (on the CPU) and differ from JAX's; their
    distributions do not."""
    from ..models.backbone import BatchNorm

    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                w = mod.weight
                fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                draw = torch.empty(w.shape)
                nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                w.copy_(draw)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, BatchNorm):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
    return module


def fresh_fine_head(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A random fine head (`fine_match.*`), initialised as flax does
    (`flax_init_`) from a torch.Generator seeded with `seed`."""
    from ..models.loftr import FinePreprocessAndMatch

    head = flax_init_(FinePreprocessAndMatch(cfg),
                      torch.Generator().manual_seed(seed))
    return {FINE_PREFIX + k: v for k, v in head.state_dict().items()}


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


def load_arch_params(path: str, arch: str) -> Dict[str, torch.Tensor]:
    """The state_dict of `arch`'s matcher (models.build_matcher, any name
    but the LoFTR family's, whose loader is load_matcher_params) from a
    flax checkpoint, as the JAX CLI restores ASpan and MatchFormer
    checkpoints into a template of the model (whose leaves do not depend
    on the compute dtype). Strict: a leaf the template lacks, or a
    parameter the file lacks, raises (so does a checkpoint of another
    arch). EfficientLoFTR, which the JAX package lacks, loads the same
    way; its published weights (transformers' names) convert with
    models.efficientloftr.from_published and state_dict_to_flax_variables
    into such a file."""
    from ..models import build_matcher

    state = flax_variables_to_state_dict(read_variables(path))
    with torch.device("meta"):
        template = build_matcher(arch).state_dict()
    match_state_dict(state, template)
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
