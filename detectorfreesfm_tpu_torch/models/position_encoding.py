"""2D sinusoidal position encoding for coarse feature maps.

The table is a copy of the JAX package's models/position_encoding.py:
channel groups of (sin x, cos x, sin y, cos y) at geometrically spaced
frequencies, computed on the host in numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _pe_table(d_model: int, h: int, w: int, temp_bug_fix: bool = True):
    """(h, w, d_model) float32 numpy table, computed once per shape."""
    pe = np.zeros((d_model, h, w), dtype=np.float32)
    y = np.arange(h, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x = np.arange(w, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    d4 = d_model // 4
    if temp_bug_fix:
        div = np.exp(
            np.arange(0, d4, 1, dtype=np.float32)
            * (-np.log(10000.0) / (d4 - 1 if d4 > 1 else 1))
        )
    else:
        div = np.exp(
            np.arange(0, d4, 1, dtype=np.float32) * (-np.log(10000.0) / d4)
        )
    div = div[:, None, None]
    pe[0::4] = np.sin(x[None] * div)
    pe[1::4] = np.cos(x[None] * div)
    pe[2::4] = np.sin(y[None] * div)
    pe[3::4] = np.cos(y[None] * div)
    return np.ascontiguousarray(np.transpose(pe, (1, 2, 0)))  # (h, w, d)


def add_position_encoding(feat):
    """feat (B, H, W, C) -> feat + PE, same dtype and device."""
    b, h, w, c = feat.shape
    pe = torch.from_numpy(_pe_table(c, h, w)).to(feat.device, feat.dtype)
    return feat + pe[None]
