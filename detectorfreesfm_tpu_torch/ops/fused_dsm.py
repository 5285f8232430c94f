"""Fused dual-softmax match extraction without the dense (L, S) matrix.

Port of the JAX package's ops/pallas_dsm.py. With
z = <f0_l, f1_s> / (C T) plus additive -1e9 masks,

  conf[l, s] = exp(2 z[l, s] - lse_r[l] - lse_c[s]),

so mutual-NN + top-K extraction needs only O(L + S) statistics: the row and
column logsumexps, and the row/column max and argmax of 2z - lse. As in the
JAX package, f0 is scaled by 1 / (C T) and both feature sets are split
once per batch into bf16 halves (f = hi + lo), and z is the three-pass
product hi0.hi1 + hi0.lo1 + lo0.hi1. Two hand-written CUDA kernels
(csrc/dual_softmax.cu), named after the TPU kernels they replace, each
form that product once and reduce it along both axes:

  dsm_pass1  (hi0, lo0, hi1, lo1, m0, m1)               -> lse_r, lse_c
  dsm_pass2  (hi0, lo0, hi1, lo1, m0, m1, lse_r, lse_c)
             -> row max/argmax of 2z - lse_c, column max/argmax of 2z - lse_r

Each wrapper runs its plain torch version for CPU tensors, launches its
kernel (a sweep and the row and column combines) for CUDA tensors, on
their card whichever card is current, or raises, and counts its launches
in `launches` (and by device in `launches_by_device`). There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .dual_softmax import CoarseMatches, topk_mutual_rows

NEG = -1e9
SOURCE = "dual_softmax.cu"
KERNEL_C = 256  # the channel count the kernels are built for (`KC`)

# Kernel launches since the last reset, by kernel name, and by device
# ("cuda:0": {name: count}).
launches = {"dsm_pass1": 0, "dsm_pass2": 0}
launches_by_device = {}


def fast_exp(x):
    """Schraudolph bit-trick exp (~±3%), bit for bit as the JAX package's
    `_fast_exp`; inputs are clamped so -1e9 logits map to ~0."""
    x = x.clamp(-87.0, 87.0)
    return (x * 12102203.0 + 1064866805.0).to(torch.int32).view(torch.float32)


def split_hi_lo(f):
    """fp32 -> (hi, lo) bf16 with f ~ hi + lo, as the JAX package splits
    its features outside the Pallas kernels."""
    hi = f.to(torch.bfloat16)
    return hi, (f - hi.float()).to(torch.bfloat16)


def _logits(hi0, lo0, hi1, lo1, m0, m1):
    """(B, L, S) masked logits from the halves, as `_sim_tile` forms them:
    three fp32 products (each bf16 x bf16 term is exact), then the row and
    the column bias."""
    h0, l0, h1, l1 = (t.float() for t in (hi0, lo0, hi1, lo1))
    z = torch.einsum("blc,bsc->bls", h0, h1)
    z += torch.einsum("blc,bsc->bls", h0, l1)
    z += torch.einsum("blc,bsc->bls", l0, h1)
    z += ((m0 - 1.0) * -NEG)[:, :, None]
    z += ((m1 - 1.0) * -NEG)[:, None, :]
    return z


def _lse(z, dim, fast):
    m = z.amax(dim=dim, keepdim=True)
    e = fast_exp(z - m) if fast else torch.exp(z - m)
    return m.squeeze(dim) + torch.log(e.sum(dim=dim).clamp(min=1e-30))


def _first_max(t, dim):
    """Max and int32 first-index argmax along dim; (NEG, 0) where nothing
    exceeds NEG, as the kernels' starting value."""
    m = t.amax(dim=dim)
    arg = t.argmax(dim=dim).to(torch.int32)
    above = m > NEG
    return (torch.where(above, m, torch.full_like(m, NEG)),
            torch.where(above, arg, torch.zeros_like(arg)))


def dsm_pass1_plain(hi0, lo0, hi1, lo1, m0, m1, fast: bool = False):
    """Plain version of dsm_pass1: (lse_r (B, L), lse_c (B, S))."""
    z = _logits(hi0, lo0, hi1, lo1, m0, m1)
    return _lse(z, 2, fast), _lse(z, 1, fast)


def dsm_pass2_plain(hi0, lo0, hi1, lo1, m0, m1, lse_r, lse_c):
    """Plain version of dsm_pass2: (row_max, row_arg) of 2z - lse_c over s
    and (col_max, col_arg) of 2z - lse_r over l."""
    z2 = 2.0 * _logits(hi0, lo0, hi1, lo1, m0, m1)
    row_max, row_arg = _first_max(z2 - lse_c[:, None, :], 2)
    z2 -= lse_r[:, :, None]
    return (row_max, row_arg, *_first_max(z2, 1))


def _check(name, hi0, lo0, hi1, lo1, m0, m1, *lse):
    if hi0.dim() != 3 or hi1.dim() != 3 or hi0.shape[0] != hi1.shape[0] \
            or hi0.shape[2] != hi1.shape[2]:
        raise ValueError(f"{name}: features must be (B, L, C) and "
                         f"(B, S, C), got {tuple(hi0.shape)}, "
                         f"{tuple(hi1.shape)}")
    bsz, na, c = hi0.shape
    nb = hi1.shape[1]
    want = [(lo0, (bsz, na, c)), (lo1, (bsz, nb, c)), (m0, (bsz, na)),
            (m1, (bsz, nb))] + list(zip(lse, [(bsz, na), (bsz, nb)]))
    for t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
    feats, vecs = [hi0, lo0, hi1, lo1], [m0, m1, *lse]
    if any(t.device != hi0.device for t in feats + vecs):
        raise ValueError(f"{name}: all inputs must be on one device")
    if any(t.dtype != torch.bfloat16 for t in feats) \
            or any(t.dtype != torch.float32 for t in vecs):
        raise ValueError(f"{name}: features must be bfloat16 halves and "
                         f"masks and lse float32")
    if hi0.device.type != "cuda":
        return
    if any(not t.is_contiguous() for t in feats + vecs):
        raise ValueError(f"{name}: inputs must be contiguous")
    if c != KERNEL_C or any(t.data_ptr() % 16 for t in feats):
        raise ValueError(f"{name}: the kernel needs C == {KERNEL_C} and "
                         f"16-byte aligned features (C={c})")
    if max(na, nb) * c >= 2 ** 31 or bsz > 65535:
        raise ValueError(f"{name}: shape {tuple(hi0.shape)} is out of range")


def _launch(name, rc, dev):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} on "
                           f"{dev}")
    launches[name] += 1
    per = launches_by_device.setdefault(str(dev), dict.fromkeys(launches, 0))
    per[name] += 1


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel library, with its C signatures declared."""
    from . import _build

    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dsm_row_tiles.argtypes = [i]
    lib.dsm_row_tiles.restype = i
    lib.dsm_splits.argtypes = [i, i, i]
    lib.dsm_splits.restype = i
    lib.dsm_pass1.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.dsm_pass1.restype = i
    lib.dsm_pass2.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.dsm_pass2.restype = i
    return lib


def _partials(lib, hi0, hi1):
    """(splits, row scratch, column scratch): one (value, value) partial
    per (split of f1, row) and per (row tile, column)."""
    bsz, na, _ = hi0.shape
    nb = hi1.shape[1]
    splits = lib.dsm_splits(bsz, na, nb)
    rows = torch.empty((bsz, splits, na, 2), dtype=torch.float32,
                       device=hi0.device)
    cols = torch.empty((bsz, lib.dsm_row_tiles(na), nb, 2),
                       dtype=torch.float32, device=hi0.device)
    return splits, rows, cols


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def dsm_pass1(hi0, lo0, hi1, lo1, m0, m1, fast: bool = False):
    """(lse_r (B, L), lse_c (B, S)): row and column logsumexp of z; masks
    are float 0/1."""
    _check("dsm_pass1", hi0, lo0, hi1, lo1, m0, m1)
    if hi0.device.type == "cpu":
        return dsm_pass1_plain(hi0, lo0, hi1, lo1, m0, m1, fast)
    lib = _lib()
    bsz, na, c = hi0.shape
    nb = hi1.shape[1]
    lse_r = torch.empty((bsz, na), dtype=torch.float32, device=hi0.device)
    lse_c = torch.empty((bsz, nb), dtype=torch.float32, device=hi0.device)
    # The library acts on the current card (SM count, shared-memory
    # limit, launch): make it the inputs' one.
    with torch.cuda.device(hi0.device):
        splits, rows, cols = _partials(lib, hi0, hi1)
        stream = torch.cuda.current_stream(hi0.device).cuda_stream
        rc = lib.dsm_pass1(*_ptrs(hi0, lo0, hi1, lo1, m0, m1, lse_r, lse_c,
                                  rows, cols),
                           bsz, na, nb, c, splits, int(fast), stream)
    _launch("dsm_pass1", rc, hi0.device)
    return lse_r, lse_c


def dsm_pass2(hi0, lo0, hi1, lo1, m0, m1, lse_r, lse_c):
    """(row_max, row_arg (B, L), col_max, col_arg (B, S)): max and int32
    first-index argmax of 2z - lse_c over s and of 2z - lse_r over l."""
    _check("dsm_pass2", hi0, lo0, hi1, lo1, m0, m1, lse_r, lse_c)
    if hi0.device.type == "cpu":
        return dsm_pass2_plain(hi0, lo0, hi1, lo1, m0, m1, lse_r, lse_c)
    lib = _lib()
    bsz, na, c = hi0.shape
    nb = hi1.shape[1]
    dev = hi0.device
    row_max = torch.empty((bsz, na), dtype=torch.float32, device=dev)
    row_arg = torch.empty((bsz, na), dtype=torch.int32, device=dev)
    col_max = torch.empty((bsz, nb), dtype=torch.float32, device=dev)
    col_arg = torch.empty((bsz, nb), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # see dsm_pass1
        splits, rows, cols = _partials(lib, hi0, hi1)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dsm_pass2(*_ptrs(hi0, lo0, hi1, lo1, m0, m1, lse_r, lse_c,
                                  row_max, row_arg, col_max, col_arg, rows,
                                  cols),
                           bsz, na, nb, c, splits, stream)
    _launch("dsm_pass2", rc, dev)
    return row_max, row_arg, col_max, col_arg


def split_features(feat0, feat1, mask0, mask1, temperature: float = 0.1):
    """(hi0, lo0, hi1, lo1, m0, m1): f0 scaled by 1 / (C T), both split
    into bf16 halves, masks as float 0/1; all contiguous."""
    f0, f1 = feat0.float(), feat1.float()
    hi0, lo0 = split_hi_lo(f0 * (1.0 / (f0.shape[-1] * temperature)))
    hi1, lo1 = split_hi_lo(f1)
    return (hi0.contiguous(), lo0.contiguous(), hi1.contiguous(),
            lo1.contiguous(), mask0.float().contiguous(),
            mask1.float().contiguous())


def dual_softmax_stats(feat0, feat1, mask0, mask1, temperature: float = 0.1,
                       fast_exp: bool = False):
    """(B, L, C), (B, S, C), bool masks -> (lse_r, lse_c, row_max_adj,
    row_arg, col_max_adj, col_arg), batched, through the kernels."""
    ops = split_features(feat0, feat1, mask0, mask1, temperature)
    lse_r, lse_c = dsm_pass1(*ops, fast_exp)
    return (lse_r, lse_c, *dsm_pass2(*ops, lse_r, lse_c))


def dual_softmax_stats_plain(feat0, feat1, mask0, mask1,
                             temperature: float = 0.1, fast_exp: bool = False):
    """The same six outputs with dense torch ops on any device."""
    ops = split_features(feat0, feat1, mask0, mask1, temperature)
    lse_r, lse_c = dsm_pass1_plain(*ops, fast_exp)
    return (lse_r, lse_c, *dsm_pass2_plain(*ops, lse_r, lse_c))


def matches_from_stats(stats, mask0, threshold: float, k: int):
    """The XLA epilogue of the JAX package's fused_extract_matches:
    conf_row = exp(row_max_adj - lse_r), threshold, mutual check, top-K."""
    lse_r, _lse_c, row_max_adj, row_arg, _col_max, col_arg = stats
    conf_row = torch.exp(row_max_adj - lse_r)
    return topk_mutual_rows(conf_row, row_arg, col_arg, mask0, threshold, k)


def fused_extract_matches(feat0, feat1, mask0, mask1, threshold: float,
                          k: int, temperature: float = 0.1,
                          fast_exp: bool = False) -> CoarseMatches:
    """Fused replacement for dual_softmax_confidence + extract_topk_matches."""
    stats = dual_softmax_stats(feat0, feat1, mask0, mask1, temperature,
                               fast_exp)
    return matches_from_stats(stats, mask0, threshold, k)
