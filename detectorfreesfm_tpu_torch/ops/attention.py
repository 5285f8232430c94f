"""Attention primitives for the matching transformers.

Port of the JAX package's ops/attention.py: elu+1 linear attention (the
O(N·d²) associativity trick) and masked full softmax attention. All take
(B, N, H, D) tensors and optional (B, N) bool masks; the normalising
reductions run in float32 whatever the input dtype. Each of JAX's
`preferred_element_type=float32` products is a product of fp32 copies
here (a bf16 einsum would return a result already rounded to bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear_attention(q, k, v, q_mask=None, kv_mask=None, eps: float = 1e-6):
    """q: (B, L, H, D); k, v: (B, S, H, D) -> (B, L, H, D) in v's dtype.

    As in JAX, the feature maps Q and K stay in the input dtype, and `k_sum`
    and `KV` are rounded to Q's dtype before the products that read them;
    all three products accumulate in fp32. In fp32 every rounding is a
    no-op."""
    dtype = v.dtype
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    if kv_mask is not None:
        K = K * kv_mask[:, :, None, None].to(K.dtype)
    # v_scale goes on KV in fp32 after the accumulating product, so the
    # numerator and denominator use the same constant.
    v_scale = 1.0 / float(max(1, k.shape[1]))
    KV = torch.einsum("bshd,bshe->bhde", K.float(), v.float()) * v_scale
    k_sum = K.float().sum(dim=1)                                  # (B, H, D)
    Qf = Q.float()
    denom = torch.einsum("blhd,bhd->blh", Qf, k_sum.to(Q.dtype).float())
    Z = 1.0 / (denom * v_scale + eps)                             # (B, L, H)
    out = torch.einsum("blhd,bhde->blhe", Qf, KV.to(Q.dtype).float())
    return (out * Z[..., None]).to(dtype)


def full_attention(q, k, v, q_mask=None, kv_mask=None):
    """Masked softmax attention. Shapes as in linear_attention."""
    dtype = v.dtype
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    logits = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], -1e9)
    attn = torch.softmax(logits, dim=-1)
    if q_mask is not None:
        attn = attn * q_mask[:, None, :, None].to(attn.dtype)
    out = torch.einsum("bhls,bshd->blhd", attn, v.float())
    return out.to(dtype)
