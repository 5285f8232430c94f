"""PNG reading and writing with numpy and the standard library's zlib.

The port's stand-in for PIL, which the GPU machine does not have: the JAX
package reads and writes the same files through PIL. The reader takes
non-interlaced gray, gray+alpha, RGB, RGBA and palette images at 8 bits
per sample (palette also at 1, 2 and 4 bits, as PIL writes small
palettes), with all five row filters. Anything else raises, naming the
file. The rows are unfiltered by csrc/pngfilter.cpp, built with g++ at
first use (utils/native.py), or, where that fails, by the same rules in
Python, some thirty times slower on Paeth rows; `last_unfilter`
names the one the last decode ran. The writer writes 8-bit gray and RGB,
each row with the filter libpng's heuristic picks (the least sum of the
filtered bytes taken as signed), as photographs are usually written.

`to_gray` and `to_rgb` convert a decoded image as PIL's convert("L") and
convert("RGB") do: ITU-R 601 luma in 16-bit fixed point, alpha ignored,
palette indices looked up.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pngfilter.cpp"

# color type -> (mode, samples per pixel)
_COLOR_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
                6: ("RGBA", 4)}


_lock = threading.Lock()
_native_lib: Optional[ctypes.CDLL] = None
_native_error: Optional[str] = None
last_unfilter: Optional[str] = None


def _load_native() -> Optional[ctypes.CDLL]:
    """Build (once) and load the C++ unfilter; None if g++ or the load
    fails (the reason stays in native_error())."""
    global _native_lib, _native_error
    with _lock:
        if _native_lib is not None or _native_error is not None:
            return _native_lib
        try:
            lib = native.build(SOURCE)
            u8 = ctypes.POINTER(ctypes.c_uint8)
            lib.png_unfilter.argtypes = [u8, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, u8]
            lib.png_unfilter.restype = ctypes.c_int
            _native_lib = lib
        except native.BUILD_ERRORS as e:
            _native_error = f"{type(e).__name__}: {e}"
        return _native_lib


def native_error() -> Optional[str]:
    """Why the C++ unfilter is unavailable (None if it loaded or was not
    tried yet)."""
    return _native_error


class PNGImage:
    """A decoded PNG: `pixels` is (H, W) uint8 for L and P, else (H, W, C);
    `palette` is the (N, 3) uint8 PLTE of a P image."""

    __slots__ = ("pixels", "mode", "palette")

    def __init__(self, pixels: np.ndarray, mode: str,
                 palette: Optional[np.ndarray] = None):
        self.pixels = pixels
        self.mode = mode
        self.palette = palette

    @property
    def size(self) -> Tuple[int, int]:
        """(W, H), as PIL's Image.size."""
        return self.pixels.shape[1], self.pixels.shape[0]


def _chunks(data: bytes, path: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _sequential_row(cur: bytearray, prev: bytes, bpp: int, kind: int):
    """Undo an Average (3) or Paeth (4) filter in place: each byte needs
    the decoded byte one pixel to its left, so the row runs byte by byte."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter_python(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The row filters undone in Python (the C++ helper's fallback)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        cur = rows[y, 1:]
        k = rows[y, 0]
        if k == 0:
            out[y] = cur
        elif k == 1:
            # bpp interleaved running sums, one per byte of a pixel
            out[y] = np.cumsum(cur.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif k == 2:
            out[y] = cur + prev  # uint8 arithmetic wraps mod 256
        else:
            row = bytearray(cur.tobytes())
            _sequential_row(row, prev.tobytes(), bpp, int(k))
            out[y] = np.frombuffer(bytes(row), np.uint8)
        prev = out[y]
    return out


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, path: str,
              unfilter: str = "auto") -> np.ndarray:
    """Undo the per-row filters of a (h * (1 + stride)) byte stream;
    `unfilter` is "auto" (C++ where it builds), "native" or "python"."""
    global last_unfilter
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown filter type {int(kinds.max())}")
    lib = None if unfilter == "python" else _load_native()
    if lib is None and unfilter == "native":
        raise RuntimeError(f"C++ unfilter unavailable: {_native_error}")
    if lib is None:
        last_unfilter = "python"
        return _unfilter_python(rows, bpp)
    rows = np.ascontiguousarray(rows)
    out = np.empty((h, stride), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.png_unfilter(rows.ctypes.data_as(u8), h, stride, bpp,
                          out.ctypes.data_as(u8))
    if rc != 0:  # kinds were checked above
        raise RuntimeError(f"{path}: C++ unfilter failed at row {rc - 1}")
    last_unfilter = "native"
    return out


def decode_png(data: bytes, path: str = "<bytes>",
               unfilter: str = "auto") -> PNGImage:
    """Decode PNG bytes (see the module docstring for what is taken);
    `unfilter` as for _unfilter."""
    header = None
    palette = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _COLOR_TYPES:
        raise ValueError(f"{path}: unknown PNG color type {ctype}")
    mode, spp = _COLOR_TYPES[ctype]
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        raise ValueError(f"{path}: {depth}-bit {mode} PNG is not supported "
                         "(8-bit samples only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if comp or filt:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    stride = (w * spp * depth + 7) // 8
    rows = _unfilter(raw, h, stride, max(1, spp * depth // 8), path,
                     unfilter)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        shifts = (depth - 1 - np.arange(depth)).astype(np.uint8)
        px = (bits.reshape(h, w, depth) << shifts).sum(-1).astype(np.uint8)
    else:
        px = rows.reshape(h, w, spp) if spp > 1 else rows.reshape(h, w)
    if ctype == 3 and px.max(initial=0) >= len(palette):
        raise ValueError(f"{path}: palette index out of range")
    return PNGImage(np.ascontiguousarray(px), mode, palette)


def read_png(path: str) -> PNGImage:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def to_gray(img: PNGImage) -> np.ndarray:
    """(H, W) uint8, as PIL's convert("L")."""
    px = img.pixels
    if img.mode == "L":
        return px
    if img.mode == "LA":
        return np.ascontiguousarray(px[..., 0])
    if img.mode == "P":
        return _luma(img.palette)[px]
    return _luma(px[..., :3])


def to_rgb(img: PNGImage) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's convert("RGB")."""
    px = img.pixels
    if img.mode == "L":
        return np.repeat(px[..., None], 3, axis=-1)
    if img.mode == "LA":
        return np.repeat(px[..., :1], 3, axis=-1)
    if img.mode == "P":
        return img.palette[px]
    return np.ascontiguousarray(px[..., :3])


def png_size(data: bytes, path: str = "<bytes>") -> Tuple[int, int]:
    """(W, H) from the IHDR chunk alone."""
    if data[:8] != SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", data[16:24])


def _filter_rows(px: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered rows of (h, stride) bytes: per row the
    filter with the least sum of |signed byte| (libpng's heuristic). Every
    filter predicts from the unfiltered image, so all five are computed
    for all rows at once."""
    h = px.shape[0]
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]
                    ).astype(np.uint8)  # wraps mod 256
    cost = np.abs(cand.view(np.int8).astype(np.int32)).sum(axis=2)
    kind = cost.argmin(axis=0)  # ties go to the lower filter, as in libpng
    return np.concatenate([kind.astype(np.uint8)[:, None],
                           cand[kind, np.arange(h)]], axis=1)


def encode_png(pixels: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of an (H, W) gray or (H, W, 3) RGB uint8 array, with
    adaptive row filters (see the module docstring)."""
    px = np.asarray(pixels)
    if px.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 pixels, not {px.dtype}")
    if px.ndim == 2:
        ctype = 0
    elif px.ndim == 3 and px.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"PNG writer takes (H, W) or (H, W, 3), not "
                         f"{px.shape}")
    h, w = px.shape[:2]
    rows = _filter_rows(px.reshape(h, -1), 1 if ctype == 0 else 3)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels, level))
