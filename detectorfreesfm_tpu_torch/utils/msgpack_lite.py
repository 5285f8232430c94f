"""Pure-Python codec of the msgpack subset that flax checkpoints use.

Counterpart of `flax.serialization.msgpack_restore` and `msgpack_serialize`:
maps, arrays, str/bin, ints, floats, nil/bool, and the flax ext types 1
(ndarray) and 3 (numpy scalar), each a nested msgpack `(shape, dtype-name,
buffer)`. Arrays come back as torch tensors in their stored dtype;
bfloat16 goes through `torch.frombuffer`, since numpy has no bfloat16.
`msgpack_serialize` writes tensors as ext type 1, as flax writes arrays.
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


_NAMES = {v: k for k, v in _DTYPES.items()}


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes):
    """A length header: the fix form below fix_max, else 8/16/32-bit."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 2 ** 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 2 ** 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        if 0 <= x < 0x80:
            out.append(x)
        elif -32 <= x < 0:
            out.append(x & 0xFF)
        elif 0 <= x < 2 ** 64:
            out += struct.pack(">BQ", 0xCF, x)
        elif -(2 ** 63) <= x < 0:
            out += struct.pack(">Bq", 0xD3, x)
        else:
            raise ValueError(f"integer out of msgpack range: {x}")
    elif isinstance(x, float):
        out += struct.pack(">Bd", 0xCB, x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, torch.Tensor):
        payload = _tensor_payload(x)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"cannot msgpack {type(x).__name__}")


def _tensor_payload(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype not in _NAMES:
        raise ValueError(f"unsupported array dtype {t.dtype}")
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() \
        else b""
    return msgpack_serialize([list(t.shape), _NAMES[t.dtype], raw])


def msgpack_serialize(obj) -> bytes:
    """Encode a tree of dicts, lists, scalars, str/bytes and tensors, as
    `flax.serialization.msgpack_serialize` does (tensors as flax's ndarray
    ext type; bfloat16 kept as bfloat16)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)
