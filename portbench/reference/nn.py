"""Plain PyTorch building blocks of the two references, on flax-named
parameter trees (`weights.py`), written from the published models.

Every convolution and product goes through a `Precision`: `FP32` computes
in float32 with TF32 off (the configurations' precision); `TF32` rounds
both operands of each one to TF32's 10-bit mantissa first and accumulates
in float32, which is what the tensor cores do with TF32 on. `TF32` is the
correctness control: the nearest precision below the configurations'.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Precision:
    def __init__(self, rnd):
        self.r = rnd

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.r(x), self.r(w), b, stride, padding)

    def einsum(self, eq, *ops):
        return torch.einsum(eq, *(self.r(o) for o in ops))

    def dense(self, x, p):
        """x @ kernel (+ bias): flax's Dense with an (in, out) kernel."""
        y = self.r(x) @ self.r(p["kernel"])
        return y + p["bias"] if "bias" in p else y


FP32 = Precision(lambda t: t)
TF32 = Precision(tf32_round)
PRECISIONS = {"fp32": FP32, "tf32": TF32}


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32 on the card, for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cudnn.allow_tf32 = saved[1]


def batch_norm(x, p, s, eps=1e-5):
    """Inference BatchNorm on NCHW: p {scale, bias}, s {mean, var}."""
    mul = p["scale"] / torch.sqrt(s["var"] + eps)
    return (x - s["mean"][:, None, None]) * mul[:, None, None] + \
        p["bias"][:, None, None]


def layer_norm(x, p, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def linear_attention(pr, q, k, v, q_mask, kv_mask, v_scale, eps=1e-6):
    """elu+1 linear attention (Katharopoulos et al. 2020), as LoFTR uses
    it: q (B, L, H, D), k and v (B, S, H, D), masks (B, L) / (B, S) bool.
    The values are scaled by `v_scale` (one over the source length of the
    padded grid) in both the numerator and the denominator."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None]
    if kv_mask is not None:
        K = K * kv_mask[:, :, None, None]
    kv = pr.einsum("bshd,bshe->bhde", K, v) * v_scale
    denom = pr.einsum("blhd,bhd->blh", Q, K.sum(1)) * v_scale + eps
    return pr.einsum("blhd,bhde->blhe", Q, kv) / denom[..., None]


def encoder_layer(pr, p, x, src, x_mask, src_mask, nhead, v_scale):
    """LoFTR's encoder layer: projections, linear attention, merge,
    LayerNorm over [x, message], a two-layer MLP and a residual add."""
    b, l, d = x.shape
    s = src.shape[1]
    q = pr.dense(x, p["q_proj"]).reshape(b, l, nhead, d // nhead)
    k = pr.dense(src, p["k_proj"]).reshape(b, s, nhead, d // nhead)
    v = pr.dense(src, p["v_proj"]).reshape(b, s, nhead, d // nhead)
    msg = linear_attention(pr, q, k, v, x_mask, src_mask, v_scale)
    msg = pr.dense(msg.reshape(b, l, d), p["merge"])
    msg = layer_norm(torch.cat([x, msg], -1), p["norm1"])
    msg = pr.dense(F.relu(pr.dense(msg, p["mlp1"])), p["mlp2"])
    return x + layer_norm(msg, p["norm2"])


def transformer(pr, p, f0, f1, m0, m1, nhead, v_scale0, v_scale1):
    """Alternating self and cross layers, `layer_{i}_{self|cross}`, in the
    order of their index. v_scale0 / v_scale1: one over the source length
    when f0 / f1 is the source."""
    names = sorted(p, key=lambda n: int(n.split("_")[1]))
    for name in names:
        lp = p[name]
        if name.endswith("self"):
            f0 = encoder_layer(pr, lp, f0, f0, m0, m0, nhead, v_scale0)
            f1 = encoder_layer(pr, lp, f1, f1, m1, m1, nhead, v_scale1)
        else:
            f0, f1 = (encoder_layer(pr, lp, f0, f1, m0, m1, nhead, v_scale1),
                      encoder_layer(pr, lp, f1, f0, m1, m0, nhead, v_scale0))
    return f0, f1


def soft_argmax(scores):
    """(..., h, w) scores -> expected (x, y) in [-1, 1] under their
    softmax, over a linspace(-1, 1) grid of each axis."""
    h, w = scores.shape[-2:]
    p = torch.softmax(scores.reshape(scores.shape[:-2] + (-1,)),
                      -1).reshape(scores.shape)
    xs = torch.linspace(-1.0, 1.0, w, device=scores.device)
    ys = torch.linspace(-1.0, 1.0, h, device=scores.device)
    ex = (p * xs[None, :]).sum((-2, -1))
    ey = (p * ys[:, None]).sum((-2, -1))
    return torch.stack([ex, ey], -1)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) *
                                       (x + 0.044715 * x ** 3)))
