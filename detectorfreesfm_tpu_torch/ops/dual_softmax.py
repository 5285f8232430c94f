"""Dual-softmax match confidence, mutual nearest neighbours and top-K.

Port of the JAX package's ops/dual_softmax.py. This dense path
materialises the (B, L, S) confidence matrix; it is the matcher's
`fused_matching=False` path and the reference the fused kernels
(ops/fused_dsm.py) are held to. Matches come out as a fixed-capacity top-K
set with a validity mask, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CoarseMatches(NamedTuple):
    """idx0/idx1: (..., K) int32 flat indices into the two coarse grids;
    conf: (..., K) float32; valid: (..., K) bool."""

    idx0: torch.Tensor
    idx1: torch.Tensor
    conf: torch.Tensor
    valid: torch.Tensor


def dual_softmax_confidence(feat0, feat1, mask0=None, mask1=None,
                            temperature: float = 0.1):
    """(B, L, C), (B, S, C) -> (B, L, S) dual-softmax confidence matrix."""
    c = feat0.shape[-1]
    f0 = feat0 / float(c) ** 0.5
    f1 = feat1 / float(c) ** 0.5
    sim = torch.einsum("blc,bsc->bls", f0.float(), f1.float()) / temperature
    if mask0 is not None:
        sim = sim.masked_fill(~mask0[:, :, None], -1e9)
    if mask1 is not None:
        sim = sim.masked_fill(~mask1[:, None, :], -1e9)
    conf = torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)
    if mask0 is not None:
        conf = conf * mask0[:, :, None].to(conf.dtype)
    if mask1 is not None:
        conf = conf * mask1[:, None, :].to(conf.dtype)
    return conf


def mutual_nearest_mask(conf):
    """(B, L, S) -> bool mask of cells that are row- and column-argmax."""
    row_max = conf.amax(dim=2, keepdim=True)
    col_max = conf.amax(dim=1, keepdim=True)
    return (conf >= row_max) & (conf >= col_max) & (conf > 0.0)


def topk_mutual_rows(row_conf, row_arg, col_arg, keep, threshold: float,
                     k: int) -> CoarseMatches:
    """Row-argmax + mutual check + top-K over the L rows.

    row_conf/row_arg: (B, L) each row's best confidence and column;
    col_arg: (B, S) each column's best row; keep: (B, L) bool pre-filter.
    A mutual-NN cell is its row's argmax, so at most one match per row."""
    b, l = row_conf.shape
    back = torch.gather(col_arg, 1, row_arg.long())
    rows = torch.arange(l, device=row_conf.device)[None, :]
    keep = keep & (row_conf > threshold) & (back == rows)
    scores = torch.where(keep, row_conf, torch.zeros_like(row_conf))
    kk = min(k, l)  # tiny grids can hold fewer rows than the K capacity
    top_conf, idx0 = torch.topk(scores, kk, dim=1)
    if kk < k:
        pad = (0, k - kk)
        top_conf = torch.nn.functional.pad(top_conf, pad)
        idx0 = torch.nn.functional.pad(idx0, pad)
    idx1 = torch.gather(row_arg, 1, idx0)
    return CoarseMatches(idx0.to(torch.int32), idx1.to(torch.int32),
                         top_conf, top_conf > threshold)


def extract_topk_matches(conf, threshold: float, k: int) -> CoarseMatches:
    """Dense (B, L, S) conf matrix -> fixed-capacity top-K match list."""
    row_max = conf.amax(dim=2)
    row_arg = conf.argmax(dim=2)  # argmax: first index on ties, as in JAX
    col_arg = conf.argmax(dim=1)
    return topk_mutual_rows(row_max, row_arg, col_arg,
                            torch.ones_like(row_max, dtype=torch.bool),
                            threshold, k)


def border_mask(h: int, w: int, border: int, valid_h=None, valid_w=None,
                device=None):
    """(..., h*w) bool mask removing `border` cells at each image edge.

    valid_h/valid_w (ints or tensors of any batch shape) make the border hug
    a live region smaller than the padded frame."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    vh = torch.as_tensor(h if valid_h is None else valid_h, device=device)
    vw = torch.as_tensor(w if valid_w is None else valid_w, device=device)
    vh = vh[..., None, None] - border
    vw = vw[..., None, None] - border
    m = (ys >= border) & (xs >= border) & (ys < vh) & (xs < vw)
    return m.reshape(m.shape[:-2] + (h * w,))
