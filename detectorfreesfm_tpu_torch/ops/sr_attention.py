"""MatchFormer's spatially-reduced attention core without its logits.

For q of shape (B, N, C) and the pooled keys and values k, v of shape
(B, M, C), `nhead` heads of C / nhead channels,

  out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h] * scale) v[b, j, h],

heads side by side in (B, N, C) (models/matchformer.py's SRAttention,
before its output projection). `sr_attention_plain` is the chain
SRAttention ran: the heads transposed out, fp32 logits in chunks of
QUERY_CHUNK queries (each chunk recomputed in the backward pass under
autograd), scale, softmax, the probabilities cast to v's dtype, the
values, the chunks concatenated and the heads transposed back. At 832 px
that chain wrote 97 GB of fp32 logits a pair and passed over them about six
times. For CUDA tensors `sr_attention` launches instead the
hand-written kernel of csrc/sr_attention.cu: one pass over the keys with a
running max and sum of exponentials per query and head, the output sums in
registers, and only (B, N, C) written. It replaces no TPU kernel: the JAX
package's SRAttention leaves the logits and the softmax to XLA. Its bound
is fp32 FFMA (the configuration keeps TF32 off): 4 N M C flops a frame,
~17.9 ms a pair at 832 px on an H100.

The kernel takes fp32 without autograd, head widths 8, 16 and 32 (the
three stages of MatchFormerConfig's defaults); models/matchformer.py keeps
the plain chain for training and for bf16, whose probabilities are rounded
to bf16 before they weight the values. For CPU tensors `sr_attention` is
the plain chain. There is no fallback from the kernel to the plain chain:
a CUDA input the kernel cannot take raises. `launches` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.checkpoint import checkpoint

SOURCE = "sr_attention.cu"
HEAD_WIDTHS = (8, 16, 32)  # channels a head the kernel is built for
QUERY_CHUNK = 4096

launches = {"sr_attention": 0}


def sr_attention_plain(q, k, v, nhead: int, scale: float):
    """The chunked chain: (B, N, C) in v's dtype. Under autograd each
    query chunk goes through torch.utils.checkpoint (JAX's
    jax.checkpoint) instead of keeping its softmax."""
    b, n, c = q.shape
    dh = c // nhead
    q = q.reshape(b, n, nhead, dh).transpose(1, 2)        # B H N D
    k = k.reshape(b, -1, nhead, dh).permute(0, 2, 3, 1)   # B H D M
    v = v.reshape(b, -1, nhead, dh).transpose(1, 2)       # B H M D
    dt = v.dtype

    def attend(qc, k, v):
        logits = torch.matmul(qc.float(), k.float()) * scale
        attn = torch.softmax(logits, dim=-1).to(dt)
        return torch.matmul(attn.float(), v.float()).to(dt)

    outs = []
    for qc in q.split(QUERY_CHUNK, dim=2):
        if torch.is_grad_enabled():
            outs.append(checkpoint(attend, qc, k, v, use_reentrant=False))
        else:
            outs.append(attend(qc, k, v))
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, n, c)


def _check(q, k, v, nhead):
    if (q.dim() != 3 or k.dim() != 3 or tuple(k.shape) != tuple(v.shape)
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]):
        raise ValueError(f"sr_attention: q must be (B, N, C) and k, v "
                         f"(B, M, C) of one B and C, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise ValueError(f"sr_attention: q, k and v must be float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("sr_attention: q, k and v must be on one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("sr_attention: q, k and v must be contiguous")
    b, n, c = q.shape
    if nhead < 1 or c % nhead:
        raise ValueError(f"sr_attention: {nhead} heads do not divide {c} "
                         f"channels")
    if q.device.type == "cpu":
        return
    if c // nhead not in HEAD_WIDTHS:
        raise ValueError(f"sr_attention: the kernel is built for head "
                         f"widths {HEAD_WIDTHS}, got {c // nhead}")
    if (min(b, n, k.shape[1]) < 1 or b > 65535 or nhead > 65535
            or max(n, k.shape[1]) * c >= 2 ** 31):
        raise ValueError(f"sr_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)} are out of range")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("sr_attention: q, k and v must be 16-byte aligned")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("sr_attention: the kernel has no backward; "
                         "run sr_attention_plain under autograd")


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel library, with its C signature declared."""
    from . import _build

    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sr_attention.argtypes = [p] * 4 + [i] * 5 + [ctypes.c_float, p]
    lib.sr_attention.restype = i
    return lib


def _launch(q, k, v, nhead, scale):
    lib = _lib()
    b, n, c = q.shape
    dev = q.device
    out = torch.empty_like(q)
    # The library acts on the current card (its shared-memory limit, the
    # launch): make it the inputs' one.
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sr_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), b, n, k.shape[1], nhead,
                              c // nhead, scale, stream)
    if rc != 0:
        raise RuntimeError(f"sr_attention: CUDA launch failed with error "
                           f"{rc} on {dev}")
    launches["sr_attention"] += 1
    return out


def sr_attention(q, k, v, nhead: int, scale: float):
    """(B, N, C) attention of q over the pooled k, v (B, M, C); float32,
    contiguous, without autograd on the card."""
    _check(q, k, v, nhead)
    if q.device.type == "cpu":
        return sr_attention_plain(q, k, v, nhead, scale)
    return _launch(q, k, v, nhead, scale)
