"""ASpan's flow expectation without the (B, L, L) similarity.

For q, k of shape (B, L, 64) fp32 on a grid of width w,

  E[b, i] = sum_j softmax_j(q_i . k_j / 8) (j mod w, floor(j / w)),

the softmax-expected (col, row) of each query over every cell of the other
grid (models/aspan.py's FlowHead). `flow_expectation_plain` is the dense
version: the similarity by `bmm`, divided in place, its row softmax and one
product with the (L, 2) cell coordinates, two (B, L, L) fp32 tensors
written and read (3.74 GB each at 832 px and B = 8). For CUDA tensors
`flow_expectation` launches instead the hand-written kernel of
csrc/flow_head.cu (and its small merge of key ranges), which keeps the
L x L block in registers: per query row a running max, sum of
exponentials and the two exponential-weighted coordinate sums over key
tiles, and only (B, L, 2) written. It replaces no TPU kernel: the JAX
package's FlowHead leaves the einsum and the softmax to XLA; it was added
because the dense chain ran at 0.9% of its roofline and took a third of an
ASpan pair. Its bound is fp32 FFMA (the configuration keeps TF32 off):
2 B L^2 64 flops a head, ~1.8 ms at 832 px and B = 8 on an H100.

Gradients go through `torch.autograd.Function` on the card: the forward is
the kernel, the backward recomputes the similarity and the probabilities
from the saved q and k in plain PyTorch (`flow_expectation_grads`), so
training keeps the dense numerics and the L x L memory in the backward
only. For CPU tensors the plain version runs, autograd and all. There is no
fallback from the kernel to the plain version: a CUDA input the kernel
cannot take raises. `launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "flow_head.cu"
WIDTH = 64     # the projection width the kernel is built for
SCALE = 0.125  # 1 / sqrt(64), an exact power of two

launches = {"flow_expectation": 0}


def grid_xy(l: int, w: int, device):
    """(L, 2) float32 (col, row) of each flat cell of a width-w grid."""
    pos = torch.arange(l, device=device, dtype=torch.float32)
    return torch.stack([pos % w, torch.div(pos, w, rounding_mode="floor")],
                       dim=-1)


def _probabilities(q, k):
    """(B, L, L) fp32 row softmax of q k^T / 8."""
    sim = torch.bmm(q, k.transpose(1, 2))
    return torch.softmax(sim.div_(8.0), dim=-1)


def flow_expectation_plain(q, k, w: int):
    """The dense version: (B, L, 2) expected (col, row) of every query."""
    p = _probabilities(q, k)                             # (B, L, L) fp32
    # The expectation as one product with the (L, 2) cell coordinates:
    # p * cols would be a second (B, L, L) tensor.
    return torch.matmul(p, grid_xy(k.shape[1], w, q.device))


def flow_expectation_grads(q, k, w: int, g):
    """(dq, dk) of sum(g * E) from q, k and g (B, L, 2), recomputing the
    probabilities p: dS = p (g_x (col_j - E_x,i) + g_y (row_j - E_y,i)),
    dq = dS k / 8, dk = dS^T q / 8."""
    grid = grid_xy(k.shape[1], w, q.device).to(q.dtype)
    p = _probabilities(q, k)
    e = torch.matmul(p, grid)
    ds = torch.matmul(g, grid.t())                       # (B, L, L)
    ds.sub_((g * e).sum(-1, keepdim=True)).mul_(p)
    del p
    return (torch.bmm(ds, k).mul_(SCALE),
            torch.bmm(ds.transpose(1, 2), q).mul_(SCALE))


def _check(q, k, w):
    if q.dim() != 3 or tuple(q.shape) != tuple(k.shape):
        raise ValueError(f"flow_expectation: q and k must be (B, L, "
                         f"{WIDTH}) of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, l, d = q.shape
    if d != WIDTH:
        raise ValueError(f"flow_expectation: the kernel is built for width "
                         f"{WIDTH}, got {d}")
    if q.dtype != torch.float32 or k.dtype != torch.float32:
        raise ValueError(f"flow_expectation: q and k must be float32, got "
                         f"{q.dtype}, {k.dtype}")
    if q.device != k.device:
        raise ValueError("flow_expectation: q and k must be on one device")
    if not (q.is_contiguous() and k.is_contiguous()):
        raise ValueError("flow_expectation: q and k must be contiguous")
    if w < 1 or l % w:
        raise ValueError(f"flow_expectation: L = {l} is not h x {w}")
    if b > 65535 or b * l >= 2 ** 31:
        raise ValueError(f"flow_expectation: shape {tuple(q.shape)} is out "
                         f"of range")


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel library, with its C signatures declared."""
    from . import _build

    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flow_tile.argtypes = []
    lib.flow_tile.restype = i
    lib.flow_splits.argtypes = [i, i]
    lib.flow_splits.restype = i
    lib.flow_expectation.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.flow_expectation.restype = i
    return lib


def _d_major(x, lp):
    """(B, L, 64) -> (B, 64, lp) contiguous, columns past L zero."""
    b, l, d = x.shape
    out = x.new_empty((b, d, lp))
    out[..., l:] = 0.0
    out[..., :l] = x.transpose(1, 2)
    return out


def _launch(q, k, w):
    lib = _lib()
    b, l, _ = q.shape
    dev = q.device
    # The library acts on the current card (SM count, shared-memory limit,
    # launch): make it the inputs' one.
    with torch.cuda.device(dev):
        tile = lib.flow_tile()
        lp = -(-l // tile) * tile
        qt, kt = _d_major(q, lp), _d_major(k, lp)
        splits = lib.flow_splits(b, l)
        part = torch.empty((splits, b, l, 4), dtype=torch.float32,
                           device=dev)
        out = torch.empty((b, l, 2), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flow_expectation(qt.data_ptr(), kt.data_ptr(),
                                  part.data_ptr(), out.data_ptr(), b, l, lp,
                                  w, splits, stream)
    if rc != 0:
        raise RuntimeError(f"flow_expectation: CUDA launch failed with "
                           f"error {rc} on {dev}")
    launches["flow_expectation"] += 1
    return out


class _FlowExpectation(torch.autograd.Function):
    """The kernel forward, the plain recomputing backward."""

    @staticmethod
    def forward(ctx, q, k, w):
        ctx.save_for_backward(q, k)
        ctx.w = w
        return _launch(q, k, w)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        dq, dk = flow_expectation_grads(q, k, ctx.w, g)
        return dq, dk, None


def flow_expectation(q, k, w: int):
    """(B, L, 2) expected (col, row) of every query of q over the cells of
    k's width-w grid; q, k (B, L, 64) float32, contiguous."""
    _check(q, k, w)
    if q.device.type == "cpu":
        return flow_expectation_plain(q, k, w)
    return _FlowExpectation.apply(q, k, w)
