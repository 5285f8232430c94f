"""A frozen, decode-only reader of the msgpack subset that flax checkpoints
use: maps, arrays, str/bin, ints, floats, nil/bool, and flax's ext types 1
(ndarray) and 3 (numpy scalar), each a nested `(shape, dtype-name,
buffer)`. Arrays come back as CPU torch tensors in their stored dtype.

The benchmark's own copy: the reference reads the bundled weights with it
and shares no code with the program under test.
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

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if b <= 0xBF:
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

    def ext(self, n: int):
        code = self.num(">b")
        payload = bytes(self.take(n))
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, buf = decode(payload)
        name = name.decode() if isinstance(name, bytes) else name
        dtype = _DTYPES[name]
        t = (torch.frombuffer(bytearray(buf), dtype=dtype).reshape(
            tuple(shape)) if len(buf) else torch.empty(tuple(shape),
                                                       dtype=dtype))
        return t if code == 1 else t.item()


_TYPES = {
    0xC0: lambda r: None, 0xC2: lambda r: False, 0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.num(">B"))),
    0xC5: lambda r: bytes(r.take(r.num(">H"))),
    0xC6: lambda r: bytes(r.take(r.num(">I"))),
    0xC7: lambda r: r.ext(r.num(">B")),
    0xC8: lambda r: r.ext(r.num(">H")),
    0xC9: lambda r: r.ext(r.num(">I")),
    0xCA: lambda r: r.num(">f"), 0xCB: lambda r: r.num(">d"),
    0xCC: lambda r: r.num(">B"), 0xCD: lambda r: r.num(">H"),
    0xCE: lambda r: r.num(">I"), 0xCF: lambda r: r.num(">Q"),
    0xD0: lambda r: r.num(">b"), 0xD1: lambda r: r.num(">h"),
    0xD2: lambda r: r.num(">i"), 0xD3: lambda r: r.num(">q"),
    0xD4: lambda r: r.ext(1), 0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4), 0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: str(r.take(r.num(">B")), "utf-8"),
    0xDA: lambda r: str(r.take(r.num(">H")), "utf-8"),
    0xDB: lambda r: str(r.take(r.num(">I")), "utf-8"),
    0xDC: lambda r: [r.value() for _ in range(r.num(">H"))],
    0xDD: lambda r: [r.value() for _ in range(r.num(">I"))],
    0xDE: lambda r: r.map(r.num(">H")),
    0xDF: lambda r: r.map(r.num(">I")),
}


def decode(data: bytes):
    """One msgpack object; trailing bytes are an error."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out
