"""ASpan's window attention (ops/span_attention.py) on the CPU: the plain
path is FlowCrossAttention's gather/einsum chain as it was, bit for bit,
the autograd Function's recomputing backward equals autograd through that
chain, and the wrapper refuses what the card's kernel cannot take. The
kernel itself is compared with the plain chain on the card
(tests/test_torch_gpu.py). Each test takes well under a second."""

import math

import pytest
import torch

from detectorfreesfm_tpu_torch.models import aspan
from detectorfreesfm_tpu_torch.ops import span_attention as sa

HW = (5, 7)  # a 35-cell grid: most 5 x 5 windows reach an edge
L = HW[0] * HW[1]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed=0, b=2, dtype=torch.float32):
    """q, k, v (b, L, 256) of logits a few units wide, and the windows of
    a flow of up to +-4 cells (clamped at every edge of the grid)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, L, 256, generator=g).to(dtype)
               for _ in "qkv")
    flow = (torch.rand(b, L, 2, generator=g) - 0.5) * 8.0
    cells = aspan.FlowCrossAttention(256, 8, 2).window_cells(flow, HW)
    return q, k, v, cells


def _old_chain(layer, x, source, hw, flow):
    """FlowCrossAttention.forward as it was before the window attention
    moved into ops/span_attention.py."""
    b, l, d = x.shape
    hn = layer.nhead
    dim = d // hn
    cells = layer.window_cells(flow, hw)
    kk = cells.shape[-1]
    idx = cells.reshape(b, l * kk, 1).expand(-1, -1, d)

    def window(t):
        return torch.gather(t, 1, idx).reshape(b, l, kk, hn, dim)

    q = layer.q_proj(x).reshape(b, l, hn, dim)
    k = window(layer.k_proj(source))
    v = window(layer.v_proj(source))
    logits = torch.einsum("blhd,blkhd->blhk", q.float(), k.float())
    attn = torch.softmax(logits / math.sqrt(dim), dim=-1).to(v.dtype)
    msg = torch.einsum("blhk,blkhd->blhd", attn.float(), v.float())
    return layer.update(x, msg.to(v.dtype).reshape(b, l, d))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flow_cross_attention_is_the_old_chain_bit_for_bit(dtype):
    """FlowCrossAttention on the CPU equals the chain it ran before, in
    fp32 and in bf16 (bf16 projections, fp32 logits and softmax, the
    probabilities rounded to bf16)."""
    dt = DTYPES[dtype]
    torch.manual_seed(0)
    layer = aspan.FlowCrossAttention(256, 8, 2, dt).eval()
    g = torch.Generator().manual_seed(1)
    x, src = (torch.randn(2, L, 256, generator=g).to(dt) for _ in "xs")
    flow = (torch.rand(2, L, 2, generator=g) - 0.5) * 8.0
    with torch.no_grad():
        got = layer(x, src, HW, flow)
        want = _old_chain(layer, x, src, HW, flow)
    assert got.dtype == dt
    assert torch.equal(got, want)


def test_cpu_runs_the_plain_chain_and_launches_nothing():
    """On the CPU the wrapper is the plain chain and nothing launches (the
    profiler's test counts the model's queries: none through the
    kernel)."""
    q, k, v, cells = _inputs(1)
    before = dict(sa.launches)
    assert torch.equal(sa.span_attention(q, k, v, cells, 8),
                       sa.span_attention_plain(q, k, v, cells, 8))
    assert sa.launches == before


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_recomputing_backward_equals_autograd_through_the_chain(
        dtype, monkeypatch):
    """The card's autograd Function, with the plain chain standing in
    for the kernel's forward: its dq, dk, dv equal autograd through the
    plain chain bit for bit (the backward is that chain, recomputed),
    and its output is the chain's."""
    q, k, v, cells = _inputs(2, dtype=DTYPES[dtype])
    weight = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(sa, "_launch", lambda q, k, v, cells:
                        sa.span_attention_plain(q, k, v, cells, 8))
    results = []
    for fn in (sa._SpanAttention.apply, sa.span_attention_plain):
        qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
        out = fn(qa, ka, va, cells, 8)
        (out.float() * weight).sum().backward()
        results.append((out, qa.grad, ka.grad, va.grad))
    for got, want in zip(*results):
        assert got.dtype == DTYPES[dtype]
        assert torch.equal(got, want)
    assert all(r.abs().max() > 1e-2 for r in results[1][1:])


def test_span_attention_grads_is_autograd_through_the_chain():
    """span_attention_grads from a given upstream gradient equals autograd
    through the plain chain, also where the windows repeat cells."""
    q, k, v, cells = _inputs(4)
    cells[:, :5] = cells[:, :5, :1]  # every cell of 5 windows the same
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    (sa.span_attention_plain(qa, ka, va, cells, 8) * g).sum().backward()
    got = sa.span_attention_grads(q, k, v, cells, 8, g)
    for a, b in zip(got, (qa.grad, ka.grad, va.grad)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["float64", "mixed", "shape", "cells_dtype",
                                  "cells_shape", "device", "layout",
                                  "heads"])
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    q, k, v, cells = _inputs(6)
    nhead = 8
    match = {"float64": "float32 or bfloat16", "mixed": "all one",
             "shape": "one shape", "cells_dtype": "int64",
             "cells_shape": "int64", "device": "one device",
             "layout": "contiguous", "heads": "do not divide"}[case]
    if case == "float64":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "mixed":
        v = v.bfloat16()
    elif case == "shape":
        k = k[:, :-1].contiguous()
    elif case == "cells_dtype":
        cells = cells.int()
    elif case == "cells_shape":
        cells = cells[:, :-1].contiguous()
    elif case == "device":
        cells = cells.to("meta")
    elif case == "layout":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        nhead = 7
    with pytest.raises(ValueError, match=match):
        sa.span_attention(q, k, v, cells, nhead)
