"""MatchFormer's SR attention core (ops/sr_attention.py).

On the CPU: the plain path is SRAttention's chunked chain as it was, bit
for bit, the CPU route launches nothing, the wrapper refuses what the
card's kernel cannot take, and SRAttention counts its queries, those the
kernel computed and the logits' bytes. Each CPU test takes well under a
second.

On the card (marked `cuda`, skipped without one): the kernel against the
plain chain at the three stages' head widths, on a ragged grid and at the
832 px cell's shapes, its refusals, and its counters. The file imports
neither jax nor the JAX package; on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_sr_attention.py
"""

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from detectorfreesfm_tpu_torch.models import matchformer
from detectorfreesfm_tpu_torch.ops import sr_attention as sr
from detectorfreesfm_tpu_torch.utils import profiler

# (query grid, channels, reduction): 4 608 queries take two 4096-query
# chunks; the other case is one chunk, at another head width.
CASES = {"two_chunks": ((72, 64), 64, 8), "one_chunk": ((24, 20), 128, 4)}


def _layer(case, seed=0):
    """An SRAttention of the case and its inputs: 2 frames of queries and a
    source map of their own grid."""
    (h, w), c, ratio = CASES[case]
    torch.manual_seed(seed)
    layer = matchformer.SRAttention(c, 8, ratio).eval()
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(2, h * w, c, generator=g)
    src = torch.randn(2, h, w, c, generator=g)
    return layer, x, src


def _old_attention(layer, x, source_map):
    """SRAttention.attention as it was before the attention core moved
    into ops/sr_attention.py."""
    b, n, c = x.shape
    hn = layer.nhead
    dh = layer.dim // hn
    kv = source_map
    if layer.sr_ratio > 1:
        kv = matchformer.avg_pool(kv, layer.sr_ratio)
    kv = kv.reshape(b, -1, c)
    q = layer.q(x).reshape(b, n, hn, dh).transpose(1, 2)
    k = layer.k(kv).reshape(b, -1, hn, dh).permute(0, 2, 3, 1)
    v = layer.v(kv).reshape(b, -1, hn, dh).transpose(1, 2)
    dt = v.dtype

    def attend(qc, k, v):
        logits = torch.matmul(qc.float(), k.float()) * layer.scale
        attn = torch.softmax(logits, dim=-1).to(dt)
        return torch.matmul(attn.float(), v.float()).to(dt)

    outs = []
    for qc in q.split(4096, dim=2):
        if torch.is_grad_enabled():
            outs.append(checkpoint(attend, qc, k, v, use_reentrant=False))
        else:
            outs.append(attend(qc, k, v))
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, n, layer.dim)
    return layer.proj(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_chain_is_the_old_attention_bit_for_bit(case):
    """In fp32, above and below the 4096-query chunk: SRAttention.attention
    (the CPU route of sr_attention) and, under autograd, the plain chain
    and its input gradient equal the old attention."""
    layer, x, src = _layer(case)
    with torch.no_grad():
        assert torch.equal(layer.attention(x, src),
                           _old_attention(layer, x, src))
    results = []
    for fn in (layer.attention, lambda a, s: _old_attention(layer, a, s)):
        xa = x.clone().requires_grad_()
        out = fn(xa, src)
        out.square().sum().backward()
        results.append((out, xa.grad))
    for got, want in zip(*results):
        assert torch.equal(got, want)


def test_cpu_route_runs_the_plain_chain_and_launches_nothing():
    layer, x, src = _layer("one_chunk", seed=2)
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 300, 128, generator=g)
    k, v = (torch.randn(2, 37, 128, generator=g) for _ in "kv")
    before = dict(sr.launches)
    assert torch.equal(sr.sr_attention(q, k, v, 8, 0.25),
                       sr.sr_attention_plain(q, k, v, 8, 0.25))
    with torch.no_grad():
        layer(x, src)
    assert sr.launches == before


@pytest.mark.parametrize("case", ["float64", "bfloat16", "mixed", "heads",
                                  "layout", "keys_shape", "batch", "rank",
                                  "device"])
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    """Dtypes other than float32, heads that do not divide the channels, a
    non-contiguous input, mismatched shapes and devices: ValueError."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 50, 64, generator=g)
    k, v = (torch.randn(2, 9, 64, generator=g) for _ in "kv")
    nhead = 8
    match = {"float64": "float32", "bfloat16": "float32",
             "mixed": "float32", "heads": "do not divide",
             "layout": "contiguous", "keys_shape": "of one B and C",
             "batch": "of one B and C", "rank": "of one B and C",
             "device": "one device"}[case]
    if case == "float64":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "bfloat16":
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    elif case == "mixed":
        v = v.double()
    elif case == "heads":
        nhead = 7
    elif case == "layout":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "keys_shape":
        v = v[:, :-1].contiguous()
    elif case == "batch":
        k, v = k[:1].contiguous(), v[:1].contiguous()
    elif case == "rank":
        q = q.reshape(2, 50, 8, 8)
    else:
        v = v.to("meta")
    with pytest.raises(ValueError, match=match):
        sr.sr_attention(q, k, v, nhead, 0.35)


def _counters(layer, x, src, grad=False):
    profiler.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.set_grad_enabled(grad):
            layer(x, src)
    return profiler.snapshot()["counters"]


def test_counters_through_the_kernel_and_the_chain(monkeypatch):
    """Under a profiler: `matchformer/sr_queries` counts 2B x N a call;
    with the launch stubbed (the plain chain standing in for the kernel
    and counting a launch) `sr_fused` counts them too and
    `logit_bytes` adds 0, a key that reads 0; through the plain chain
    (the CPU route, or autograd) `sr_fused` adds 0 and `logit_bytes`
    2B x heads x N x M x 4."""
    layer, x, src = _layer("one_chunk", seed=5)
    n, m = x.shape[1], (24 // 4) * (20 // 4)
    dense = 2 * 8 * n * m * 4
    assert _counters(layer, x, src) == {
        "matchformer/sr_queries": 2 * n, "matchformer/sr_fused": 0,
        "matchformer/logit_bytes": dense}
    assert _counters(layer, x, src, grad=True) == {
        "matchformer/sr_queries": 2 * n, "matchformer/sr_fused": 0,
        "matchformer/logit_bytes": dense}

    def stub(q, k, v, nhead, scale):
        sr.launches["sr_attention"] += 1
        return sr.sr_attention_plain(q, k, v, nhead, scale)

    monkeypatch.setattr(sr, "sr_attention", stub)
    monkeypatch.setitem(sr.launches, "sr_attention", 0)
    assert _counters(layer, x, src) == {
        "matchformer/sr_queries": 2 * n, "matchformer/sr_fused": 2 * n,
        "matchformer/logit_bytes": 0}
    assert sr.launches["sr_attention"] == 1


# --- on the card ------------------------------------------------------------


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")


def _kernel_errors(n, m, c, frames=2, seed=0):
    """The kernel against the plain chain on seeded q, k, v (logits of
    standard deviation ~2): the largest |difference|, the largest |plain|
    value, and the launches the call made."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = 2.0 * torch.randn(frames, n, c, device="cuda", generator=g)
    k, v = (torch.randn(frames, m, c, device="cuda", generator=g)
            for _ in "kv")
    scale = float(torch.tensor(c // 8, dtype=torch.float32).rsqrt())
    before = sr.launches["sr_attention"]
    with torch.no_grad():
        got = sr.sr_attention(q, k, v, 8, scale)
        plain = sr.sr_attention_plain(q, k, v, 8, scale)
    assert got.shape == q.shape and got.dtype == torch.float32
    return dict(kernel=(got - plain).abs().max().item(),
                scale=plain.abs().max().item(),
                launches=sr.launches["sr_attention"] - before)


# Each stage of an 832 px frame: (queries, channels); every stage attends
# to the 52 x 52 pooled keys.
CELL_STAGES = {"stride2": (173056, 64), "stride4": (43264, 128),
               "stride8": (10816, 256)}
RATIOS = {64: 8, 128: 4, 256: 2}  # the stages' reductions by width


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128, 256])
def test_kernel_on_a_ragged_grid(c):
    """A 26 x 34 query grid (884 queries, not a multiple of a block's)
    and its keys pooled by the stage's ratio (12, 48 and 221 keys, not a
    multiple of a tile), head widths 8, 16, 32: within 1e-5 of the
    plain chain's largest value (sums of up to M terms in another order,
    and ex2.approx's 2 ulp), one launch."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    r = RATIOS[c]
    e = _kernel_errors(26 * 34, (26 // r) * (34 // r), c, seed=c)
    assert e["launches"] == 1
    assert e["kernel"] <= 1e-5 * e["scale"], e


@pytest.mark.cuda
@pytest.mark.parametrize("stage", sorted(CELL_STAGES))
def test_kernel_at_the_cell_shapes(stage):
    """Two frames at each stage of the 832 px cell, M = 2 704 keys: within
    1e-5 of the plain chain's largest value, as on the ragged grid."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    n, c = CELL_STAGES[stage]
    e = _kernel_errors(n, 2704, c, seed=n)
    assert e["launches"] == 1
    assert e["kernel"] <= 1e-5 * e["scale"], (stage, e)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["width", "autograd"])
def test_kernel_refuses_other_widths_and_autograd(case):
    """The plain chain takes any head width and autograd; on the card the
    kernel's widths 8, 16, 32 without autograd, or a ValueError."""
    _needs_cuda()
    c = 32 if case == "width" else 64
    q = torch.randn(1, 40, c, device="cuda")
    k, v = (torch.randn(1, 9, c, device="cuda") for _ in "kv")
    if case == "autograd":
        q.requires_grad_()
    match = {"width": "built for", "autograd": "no backward"}[case]
    with pytest.raises(ValueError, match=match):
        sr.sr_attention(q, k, v, 8, 0.5)


@pytest.mark.cuda
def test_sr_attention_counts_its_queries_through_the_kernel():
    """An SRAttention on the card under a profiler: every query counted as
    computed by the kernel (the share sr_fused_pct reads), no logits'
    bytes, one launch; its output within 1e-5 of the largest value of the
    same layer on the CPU."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    layer, x, src = _layer("one_chunk", seed=6)
    with torch.no_grad():
        want = layer(x, src)
    layer.cuda()
    before = sr.launches["sr_attention"]
    counters = _counters(layer, x.cuda(), src.cuda())
    assert sr.launches["sr_attention"] == before + 1
    n = x.shape[1]
    assert counters == {"matchformer/sr_queries": 2 * n,
                        "matchformer/sr_fused": 2 * n,
                        "matchformer/logit_bytes": 0}
    with torch.no_grad():
        got = layer(x.cuda(), src.cuda()).cpu()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
