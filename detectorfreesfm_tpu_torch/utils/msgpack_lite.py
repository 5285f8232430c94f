"""Pure-Python decoder of the msgpack subset that flax checkpoints use.

Counterpart of `flax.serialization.msgpack_restore`: maps, arrays, str/bin,
ints, floats, nil/bool, and the flax ext types 1 (ndarray) and 3 (numpy
scalar), each a nested msgpack `(shape, dtype-name, buffer)`. Arrays come
back as torch tensors in their stored dtype; bfloat16 goes through
`torch.frombuffer`, since numpy has no bfloat16.
"""

from __future__ import annotations

import struct

import torch

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b not in _TYPES:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return _TYPES[b](self)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload).item()
        raise ValueError(f"unsupported msgpack ext type {code}")


# Type byte -> decoder of what follows it, for the non-fixed formats.
_TYPES = {
    0xC0: lambda r: None, 0xC2: lambda r: False, 0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.unpack(">B"))),
    0xC5: lambda r: bytes(r.take(r.unpack(">H"))),
    0xC6: lambda r: bytes(r.take(r.unpack(">I"))),
    0xC7: lambda r: r.ext(r.unpack(">B")),
    0xC8: lambda r: r.ext(r.unpack(">H")),
    0xC9: lambda r: r.ext(r.unpack(">I")),
    0xCA: lambda r: r.unpack(">f"), 0xCB: lambda r: r.unpack(">d"),
    0xCC: lambda r: r.unpack(">B"), 0xCD: lambda r: r.unpack(">H"),
    0xCE: lambda r: r.unpack(">I"), 0xCF: lambda r: r.unpack(">Q"),
    0xD0: lambda r: r.unpack(">b"), 0xD1: lambda r: r.unpack(">h"),
    0xD2: lambda r: r.unpack(">i"), 0xD3: lambda r: r.unpack(">q"),
    0xD4: lambda r: r.ext(1), 0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4), 0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: str(r.take(r.unpack(">B")), "utf-8"),
    0xDA: lambda r: str(r.take(r.unpack(">H")), "utf-8"),
    0xDB: lambda r: str(r.take(r.unpack(">I")), "utf-8"),
    0xDC: lambda r: r.array(r.unpack(">H")),
    0xDD: lambda r: r.array(r.unpack(">I")),
    0xDE: lambda r: r.map(r.unpack(">H")),
    0xDF: lambda r: r.map(r.unpack(">I")),
}


def _ndarray(payload: bytes) -> torch.Tensor:
    shape, name, buf = msgpack_restore(payload)
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _DTYPES:
        raise ValueError(f"unsupported array dtype {name!r}")
    dtype = _DTYPES[name]
    if len(buf) == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(bytearray(buf), dtype=dtype).reshape(tuple(shape))


def msgpack_restore(data: bytes):
    """Decode one msgpack object: the same tree as
    `flax.serialization.msgpack_restore`, with tensors as array leaves.
    Trailing bytes are an error."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out
