"""The random draws of the JAX package, reproduced without JAX.

RANSAC in the JAX package draws its minimal samples as the top-k of
`jax.random.gumbel(key, (H, N))` with raw uint32[2] keys, which the mapper
derives from content hashes (`_stable_rngs`). The port's estimators take
the Gumbel array as an input; this module makes the same array from the
same key, so the port and the JAX package verify a pair from the same
samples.

`jax.random.gumbel` (float32, the default "low" mode) is
  u = max(tiny, f + tiny),  f = bitcast((bits >> 9) | 0x3F800000) - 1
  g = -log(-log(u))
where `bits` is threefry2x32 of the key over the flat element index,
split into 64-bit counters (high word, low word) and xor-ed: JAX's
partitionable layout (`jax_threefry_partitionable`, on by default in JAX
0.9). The uniform draws are bit-exact; `log` rounds differently on each
backend, by an ulp or so.

Integer arithmetic runs in int64 with a 32-bit mask, since torch has no
full uint32 arithmetic. The draws are made on `device` (None means CUDA,
as for every entry point of the port; the CPU only when asked).

The trainers' draws are here too: `PRNGKey`, `split`, `fold_in`,
`uniform`, `randint` and `normal` take and give raw uint32[2] keys as
numpy arrays and follow `jax.random` with the same layout. `uniform` and
`randint` are bit-exact; `normal` goes through `erfinv`, which may differ
by an ulp or so.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ..device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 with 20 rounds (as JAX's lowering): int64 tensors
    holding uint32 values, broadcast together. Returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def random_bits(key, shape, device=None) -> torch.Tensor:
    """JAX's 32-bit `random_bits(key, 32, shape)` for one raw uint32[2] key,
    as int64 values in [0, 2^32), on `device` (None: CUDA)."""
    k = np.asarray(key, np.uint32).astype(np.int64)
    n = int(np.prod(shape))
    if n >= 2 ** 32:
        raise ValueError("draws of 2^32 or more elements are not supported")
    lo = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    b0, b1 = threefry2x32(int(k[0]), int(k[1]), torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape(shape)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 uniform on [tiny, 1) from 32-bit draws."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f + _TINY, _TINY)


def gumbel(keys, shape, device=None) -> torch.Tensor:
    """`jax.random.gumbel(key, shape)` (float32) for a raw key (2,) or a
    batch of keys (..., 2), as vmap over the keys gives: out (..., *shape),
    on `device` (None: CUDA)."""
    dev = resolve_device(device)
    keys = np.asarray(keys, np.uint32)
    shape = tuple(int(s) for s in shape)
    flat = keys.reshape(-1, 2)
    out = torch.empty((len(flat),) + shape, dtype=torch.float32, device=dev)
    for i, k in enumerate(flat):
        u = uniform_from_bits(random_bits(k, shape, dev))
        out[i] = -torch.log(-torch.log(u))
    return out.reshape(keys.shape[:-1] + shape)


def stable_rngs(entries, seed: int = 0) -> np.ndarray:
    """(n, 2) uint32 PRNG keys from stable content hashes of each entry
    (a tuple such as ("verify", name0, name1, factor_index)).

    Copy of the JAX package's `IncrementalMapper._stable_rngs`: each entity
    hashes to its own key, so RANSAC outcomes do not depend on how calls
    are batched or ordered."""
    salt = (seed * 2654435761) & _MASK
    out = np.empty((len(entries), 2), np.uint32)
    for i, parts in enumerate(entries):
        s = "|".join(str(p) for p in parts).encode()
        out[i, 0] = zlib.crc32(s) ^ salt
        out[i, 1] = zlib.crc32(b"\x9e" + s)
    return out


def PRNGKey(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: the raw key [0, seed] of a 32-bit
    seed."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def _threefry_pairs(key, n: int):
    """threefry2x32 of `key` over counters (0, i), i < n, as numpy uint32
    words (both unxored)."""
    k = np.asarray(key, np.uint32).astype(np.int64)
    lo = torch.arange(n, dtype=torch.int64)
    b0, b1 = threefry2x32(int(k[0]), int(k[1]), torch.zeros_like(lo), lo)
    return b0.numpy().astype(np.uint32), b1.numpy().astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: (num, 2) uint32 keys."""
    b0, b1 = _threefry_pairs(key, num)
    return np.stack([b0, b1], -1)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` for a 32-bit integer."""
    k = np.asarray(key, np.uint32).astype(np.int64)
    b0, b1 = threefry2x32(int(k[0]), int(k[1]),
                          torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _MASK]))
    return np.array([int(b0[0]), int(b1[0])], np.uint32)


def uniform(key, shape=(), minval=0.0, maxval=1.0, device=None
            ) -> torch.Tensor:
    """`jax.random.uniform(key, shape, minval=, maxval=)` in float32:
    max(minval, fma(f, maxval - minval, minval)), f in [0, 1) from the top
    23 bits, with the bounds rounded to float32 first."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    bits = random_bits(key, shape, dev)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=dev)
    hi = torch.tensor(maxval, dtype=torch.float32, device=dev)
    # XLA fuses the scale and shift into one fused multiply-add: the
    # float32 product is exact in float64, so one rounding of the float64
    # sum gives the same float32 (double rounding aside, which the tests
    # would show).
    r = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, r)


def randint(key, shape, minval: int, maxval: int, device=None
            ) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32): two 32-bit
    draws from split(key) combined modulo the span, as JAX does."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    k1, k2 = split(key, 2)
    hi = random_bits(k1, shape, dev)
    lo = random_bits(k2, shape, dev)
    span = maxval - minval if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span  # uint32 wraps, as in JAX
    off = ((((hi % span) * mult) & _MASK) + (lo % span)) & _MASK
    return (minval + off % span).to(torch.int32)


def normal(key, shape=(), device=None) -> torch.Tensor:
    """`jax.random.normal(key, shape)` in float32: sqrt(2) erfinv(u), u
    uniform on (nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return torch.erfinv(u) * float(np.float32(np.sqrt(2.0)))
