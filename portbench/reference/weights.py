"""The bundled flax checkpoints as trees of float32 tensors for the
references: convolution kernels (kh, kw, in, out) become (out, in, kh,
kw); Dense kernels stay (in, out); BatchNorm statistics stay apart under
`batch_stats`. Names are flax's, as the file stores them."""

from __future__ import annotations

import torch

from .msgpack import decode


def _convert(tree, device):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _convert(v, device)
        else:
            t = v.float()
            if k == "kernel" and t.dim() == 4:
                t = t.permute(3, 2, 0, 1)
            out[k] = t.contiguous().to(device)
    return out


def load(path: str, device) -> dict:
    """{"params": ..., "batch_stats": ...} of a checkpoint written as
    {params: variables[, step]}."""
    with open(path, "rb") as f:
        raw = decode(f.read())
    variables = raw.get("params", raw)
    if "params" not in variables:
        variables = {"params": variables}
    return {k: _convert(v, device) for k, v in variables.items()}
