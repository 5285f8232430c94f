"""Fused dual-softmax match extraction without the dense (L, S) matrix.

Port of the JAX package's ops/pallas_dsm.py. With
z = <f0_l, f1_s> / (C T) plus additive -1e9 masks,

  conf[l, s] = exp(2 z[l, s] - lse_r[l] - lse_c[s]),

so mutual-NN + top-K extraction needs only O(L + S) statistics: the row and
column logsumexps, and the row/column max and argmax of 2z - lse. Two
hand-written CUDA kernels (csrc/dual_softmax.cu) compute them, each a row
reduction over one orientation, launched on both orientations:

  dsm_row_lse     (A, B)          -> logsumexp_s z_AB[r, s]
  dsm_row_argmax  (A, B, bias_B)  -> max/argmax_s 2 z_AB[r, s] - bias_B[s]

Each wrapper runs its plain torch version for CPU tensors, launches its
kernel for CUDA tensors (or raises), and counts its launches in
`launches`. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .dual_softmax import CoarseMatches, topk_mutual_rows

NEG = -1e9
SOURCE = "dual_softmax.cu"

# Kernel launches since the last reset, by kernel name.
launches = {"dsm_row_lse": 0, "dsm_row_argmax": 0}


def fast_exp(x):
    """Schraudolph bit-trick exp (~±3%), bit for bit as the JAX package's
    `_fast_exp`; inputs are clamped so -1e9 logits map to ~0."""
    x = x.clamp(-87.0, 87.0)
    return (x * 12102203.0 + 1064866805.0).to(torch.int32).view(torch.float32)


def _logits(a, b, ma, mb, scale: float):
    """(B, na, nb) masked logits, rounded as the kernel rounds them."""
    z = torch.einsum("bnc,bmc->bnm", a, b) * scale
    z = z + ((ma - 1.0) * -NEG)[:, :, None]
    return z + ((mb - 1.0) * -NEG)[:, None, :]


def row_lse_plain(a, b, ma, mb, scale: float, fast: bool = False):
    """Plain version of dsm_row_lse: (B, na) logsumexp over b's rows."""
    z = _logits(a, b, ma, mb, scale)
    m = z.amax(dim=2, keepdim=True)
    e = fast_exp(z - m) if fast else torch.exp(z - m)
    return m[..., 0] + torch.log(e.sum(dim=2).clamp(min=1e-30))


def row_argmax_plain(a, b, ma, mb, bias, scale: float):
    """Plain version of dsm_row_argmax: (B, na) max and int32 first-index
    argmax of 2 z - bias; (NEG, 0) where nothing exceeds NEG, as the
    kernel's starting value."""
    t = 2.0 * _logits(a, b, ma, mb, scale) - bias[:, None, :]
    m = t.amax(dim=2)
    arg = t.argmax(dim=2).to(torch.int32)
    above = m > NEG
    return (torch.where(above, m, torch.full_like(m, NEG)),
            torch.where(above, arg, torch.zeros_like(arg)))


def _check(name, a, b, ma, mb, *extra):
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[2]:
        raise ValueError(f"{name}: features must be (B, na, C) and "
                         f"(B, nb, C), got {tuple(a.shape)}, {tuple(b.shape)}")
    bsz, na, c = a.shape
    nb = b.shape[1]
    want = [(ma, (bsz, na)), (mb, (bsz, nb))] + [(e, (bsz, nb)) for e in extra]
    for t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
    tensors = [a, b, ma, mb, *extra]
    if any(t.device != a.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name}: all inputs must be float32")
    if a.device.type != "cuda":
        return
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if c % 4 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs C % 4 == 0 and 16-byte "
                         f"aligned features (C={c})")
    if max(na, nb) * c >= 2 ** 31 or bsz > 65535:
        raise ValueError(f"{name}: shape {tuple(a.shape)} is out of range")


def _launch(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    launches[name] += 1


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel library, with its C signatures declared."""
    from . import _build

    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dsm_row_lse.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float,
                                i, p]
    lib.dsm_row_lse.restype = i
    lib.dsm_row_argmax.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                   ctypes.c_float, p]
    lib.dsm_row_argmax.restype = i
    return lib


def dsm_row_lse(a, b, ma, mb, scale: float, fast: bool = False):
    """(B, na) logsumexp over s of z[r, s]; masks are float 0/1."""
    _check("dsm_row_lse", a, b, ma, mb)
    if a.device.type == "cpu":
        return row_lse_plain(a, b, ma, mb, scale, fast)
    bsz, na, c = a.shape
    out = torch.empty((bsz, na), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _lib().dsm_row_lse(a.data_ptr(), b.data_ptr(), ma.data_ptr(),
                            mb.data_ptr(), out.data_ptr(), bsz, na,
                            b.shape[1], c, scale, int(fast), stream)
    _launch("dsm_row_lse", rc)
    return out


def dsm_row_argmax(a, b, ma, mb, bias, scale: float):
    """(B, na) max and int32 argmax over s of 2 z[r, s] - bias[s]."""
    _check("dsm_row_argmax", a, b, ma, mb, bias)
    if a.device.type == "cpu":
        return row_argmax_plain(a, b, ma, mb, bias, scale)
    bsz, na, c = a.shape
    out_max = torch.empty((bsz, na), dtype=torch.float32, device=a.device)
    out_arg = torch.empty((bsz, na), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _lib().dsm_row_argmax(a.data_ptr(), b.data_ptr(), ma.data_ptr(),
                               mb.data_ptr(), bias.data_ptr(),
                               out_max.data_ptr(), out_arg.data_ptr(), bsz,
                               na, b.shape[1], c, scale, stream)
    _launch("dsm_row_argmax", rc)
    return out_max, out_arg


def _prepare(feat0, feat1, mask0, mask1):
    return (feat0.float().contiguous(), feat1.float().contiguous(),
            mask0.float().contiguous(), mask1.float().contiguous())


def dual_softmax_stats(feat0, feat1, mask0, mask1, temperature: float = 0.1,
                       fast_exp: bool = False):
    """(B, L, C), (B, S, C), bool masks -> (lse_r, lse_c, row_max_adj,
    row_arg, col_max_adj, col_arg), batched, through the kernels."""
    f0, f1, m0, m1 = _prepare(feat0, feat1, mask0, mask1)
    scale = 1.0 / (f0.shape[-1] * temperature)
    lse_r = dsm_row_lse(f0, f1, m0, m1, scale, fast_exp)
    lse_c = dsm_row_lse(f1, f0, m1, m0, scale, fast_exp)
    row_max, row_arg = dsm_row_argmax(f0, f1, m0, m1, lse_c, scale)
    col_max, col_arg = dsm_row_argmax(f1, f0, m1, m0, lse_r, scale)
    return lse_r, lse_c, row_max, row_arg, col_max, col_arg


def dual_softmax_stats_plain(feat0, feat1, mask0, mask1,
                             temperature: float = 0.1, fast_exp: bool = False):
    """The same six outputs with dense torch ops on any device."""
    f0, f1, m0, m1 = _prepare(feat0, feat1, mask0, mask1)
    scale = 1.0 / (f0.shape[-1] * temperature)
    lse_r = row_lse_plain(f0, f1, m0, m1, scale, fast_exp)
    lse_c = row_lse_plain(f1, f0, m1, m0, scale, fast_exp)
    row_max, row_arg = row_argmax_plain(f0, f1, m0, m1, lse_c, scale)
    col_max, col_arg = row_argmax_plain(f1, f0, m1, m0, lse_r, scale)
    return lse_r, lse_c, row_max, row_arg, col_max, col_arg


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
