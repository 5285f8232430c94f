"""ASpan's window attention without gathered keys and values.

For q, k, v of shape (B, L, C) on a grid of L cells, `nhead` heads of
C / nhead channels, and cells (B, L, K2) int64, the flat cells of each
query's window in the other grid (models/aspan.py's
FlowCrossAttention.window_cells),

  out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, c_ij, h] / sqrt(C / nhead))
                 v[b, c_ij, h],

the message of FlowCrossAttention, (B, L, C) in v's dtype.
`span_attention_plain` is the chain FlowCrossAttention ran: each query's
window rows of k and v gathered into (B, L x K2, C), an fp32 einsum for the
logits, the softmax, the probabilities cast to v's dtype, an fp32 einsum
for the values, the message cast to v's dtype. On the card that chain wrote
2.2 GB for each gathered tensor at 832 px and B = 8 and moved ~17.6 GB a
call through permuting copies and batched gemvs. For CUDA tensors
`span_attention` launches instead the hand-written kernel of
csrc/span_attention.cu, which reads each window's rows in place (a warp a
query; logits, softmax and sum in registers) and writes only the message.
It replaces no TPU kernel: the JAX package's FlowCrossAttention leaves the
gather and the einsums to XLA. Its bound is memory: q, k, v, the message and
the cells read or written once, ~0.37 GB a call at 832 px and B = 8, 0.111
ms at 3.35 TB/s. The kernel is built for C = 256, 8 heads and 5 x 5
windows (the ASpan configuration), in fp32 and bf16.

Gradients go through `torch.autograd.Function` on the card: the forward is
the kernel, the backward recomputes the plain chain from the saved q, k, v
and cells and differentiates it (`span_attention_grads`), so training keeps
the chain's numerics. For CPU tensors the plain chain runs, autograd and
all. There is no fallback from the kernel to the plain chain: a CUDA input
the kernel cannot take raises. `launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

SOURCE = "span_attention.cu"
WIDTH = 256   # channels the kernel is built for
HEADS = 8     # heads of WIDTH / HEADS = 32 channels
WINDOW = 25   # cells of a 5 x 5 window
DTYPES = (torch.float32, torch.bfloat16)

launches = {"span_attention": 0}


def span_attention_plain(q, k, v, cells, nhead: int):
    """The gather/einsum chain: (B, L, C) message in v's dtype."""
    b, l, d = q.shape
    kk = cells.shape[-1]
    dim = d // nhead
    # Projecting the source, then gathering its rows, is the dense layer on
    # the gathered window row by row (25x fewer products).
    idx = cells.reshape(b, l * kk, 1).expand(-1, -1, d)

    def window(t):
        return torch.gather(t, 1, idx).reshape(b, l, kk, nhead, dim)

    qh = q.reshape(b, l, nhead, dim)
    kw, vw = window(k), window(v)
    logits = torch.einsum("blhd,blkhd->blhk", qh.float(), kw.float())
    attn = torch.softmax(logits / math.sqrt(dim), dim=-1).to(v.dtype)
    msg = torch.einsum("blhk,blkhd->blhd", attn.float(), vw.float())
    return msg.to(v.dtype).reshape(b, l, d)


def span_attention_grads(q, k, v, cells, nhead: int, g):
    """(dq, dk, dv) of sum(g * out): autograd through the plain chain,
    recomputed from q, k, v and cells."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        out = span_attention_plain(*inputs, cells, nhead)
        return torch.autograd.grad(out, inputs, g)


def _check(q, k, v, cells, nhead):
    if q.dim() != 3 or not tuple(q.shape) == tuple(k.shape) == tuple(
            v.shape):
        raise ValueError(f"span_attention: q, k and v must be (B, L, C) of "
                         f"one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, l, d = q.shape
    if q.dtype not in DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"span_attention: q, k and v must be float32 or "
                         f"bfloat16, all one, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if (cells.dtype != torch.int64 or cells.dim() != 3
            or tuple(cells.shape[:2]) != (b, l)):
        raise ValueError(f"span_attention: cells must be (B, L, K2) int64 "
                         f"for q of {tuple(q.shape)}, got "
                         f"{tuple(cells.shape)} {cells.dtype}")
    if not q.device == k.device == v.device == cells.device:
        raise ValueError("span_attention: q, k, v and cells must be on one "
                         "device")
    if not all(t.is_contiguous() for t in (q, k, v, cells)):
        raise ValueError("span_attention: q, k, v and cells must be "
                         "contiguous")
    if nhead < 1 or d % nhead:
        raise ValueError(f"span_attention: {nhead} heads do not divide "
                         f"{d} channels")
    if q.device.type == "cpu":
        return
    if (d, nhead, cells.shape[2]) != (WIDTH, HEADS, WINDOW):
        raise ValueError(f"span_attention: the kernel is built for "
                         f"{WIDTH} channels, {HEADS} heads and {WINDOW} "
                         f"cells, got {d}, {nhead}, {cells.shape[2]}")
    if b * l >= 2 ** 31:
        raise ValueError(f"span_attention: shape {tuple(q.shape)} is out of "
                         f"range")


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel library, with its C signatures declared."""
    from . import _build

    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.span_attention_f32, lib.span_attention_bf16):
        fn.argtypes = [p] * 5 + [i] * 2 + [p]
        fn.restype = i
    return lib


def _launch(q, k, v, cells):
    lib = _lib()
    b, l, _ = q.shape
    dev = q.device
    fn = (lib.span_attention_f32 if q.dtype == torch.float32
          else lib.span_attention_bf16)
    out = torch.empty_like(v)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cells.data_ptr(),
                out.data_ptr(), b, l, stream)
    if rc != 0:
        raise RuntimeError(f"span_attention: CUDA launch failed with error "
                           f"{rc} on {dev}")
    launches["span_attention"] += 1
    return out


class _SpanAttention(torch.autograd.Function):
    """The kernel forward, the plain recomputing backward."""

    @staticmethod
    def forward(ctx, q, k, v, cells, nhead):
        ctx.save_for_backward(q, k, v, cells)
        ctx.nhead = nhead
        return _launch(q, k, v, cells)

    @staticmethod
    def backward(ctx, g):
        q, k, v, cells = ctx.saved_tensors
        return (*span_attention_grads(q, k, v, cells, ctx.nhead, g), None,
                None)


def span_attention(q, k, v, cells, nhead: int):
    """(B, L, C) message of each query's window attention; q, k, v
    (B, L, C) float32 or bfloat16, cells (B, L, K2) int64, all
    contiguous."""
    _check(q, k, v, cells, nhead)
    if q.device.type == "cpu":
        return span_attention_plain(q, k, v, cells, nhead)
    return _SpanAttention.apply(q, k, v, cells, nhead)
