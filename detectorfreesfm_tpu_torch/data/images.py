"""Image loading, resizing and padding to a fixed square frame, without PIL.

Port of the JAX package's data/images.py. `load_gray` decodes through one
of two backends:

  * "png": data/png.py (zlib, with the row filters undone in C++) and a
    numpy copy of the native resize, which adds in the same order and
    gives the same floats. It needs no system library, so it is the one
    that runs wherever the port does.
  * "native": csrc/imageloader.cpp (the port's copy of the JAX package's
    native/imageloader.cpp, which links libjpeg and libpng), built with g++
    at first use into the gitignored build/native/ at the repo root (never
    into native/). JPEG luma comes straight from the Y channel; the resize
    is Pillow's triangle filter in double precision.

"auto" reads PNG files with the png path and everything else with the
native one, which raises, naming the missing libjpeg/libpng, where the
library does not build. ctypes and zlib release the GIL, so a thread pool
decodes in parallel on either path. `last_backend` names the backend that
decoded the last image (threads share it, so read it after a run).
`image_size` reads (W, H) from a PNG or JPEG header in Python, and
`sample_colors` gives point colours as the JAX package's PIL path does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import struct
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils import native
from . import png

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "imageloader.cpp"
LIBS = ("-ljpeg", "-lpng")
BACKENDS = ("auto", "native", "png")

_lock = threading.Lock()
_native_lib: Optional[ctypes.CDLL] = None
_native_error: Optional[str] = None
last_backend: Optional[str] = None


@dataclasses.dataclass
class LoadedImage:
    """A grayscale image resized to fit (target, target) and zero-padded.

    scale maps network coords back to original pixels: orig = net * scale.
    """

    data: np.ndarray  # (H_pad, W_pad) float32 in [0, 1]
    scale: np.ndarray  # (2,) float32 (sx, sy)
    orig_size: tuple  # (W, H) of the file on disk
    valid_size: tuple  # (w, h) of the live region inside the padded frame


def _resize_dims(w: int, h: int, long_side: int, df: int) -> tuple:
    """Scale so max(w, h) == long_side, then snap each dim down to the
    divisor grid (df=8 keeps 1/8-resolution features integral)."""
    scale = long_side / max(w, h)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    nw = max(df, (nw // df) * df)
    nh = max(df, (nh // df) * df)
    return nw, nh


# -- the native loader --------------------------------------------------------


def library_path() -> Path:
    """build/native/libimageloader_<hash of source, flags and libs>.so"""
    return native.library_path(SOURCE, LIBS)


def _load_native() -> Optional[ctypes.CDLL]:
    """Build (once) and load the C++ loader; None if g++, libjpeg/libpng
    or the load fails (the reason stays in native_error())."""
    global _native_lib, _native_error
    with _lock:
        if _native_lib is not None or _native_error is not None:
            return _native_lib
        try:
            lib = native.build(SOURCE, LIBS)
            fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
            lib.decode_gray_resize.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                fp, ip]
            lib.decode_gray_resize.restype = ctypes.c_int
            lib.image_size.argtypes = [ctypes.c_char_p, ip]
            lib.image_size.restype = ctypes.c_int
            lib.decode_rgb.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_long, ip]
            lib.decode_rgb.restype = ctypes.c_int
            _native_lib = lib
        except native.BUILD_ERRORS as e:
            _native_error = f"{type(e).__name__}: {e}"
        return _native_lib


def native_error() -> Optional[str]:
    """Why the native loader is unavailable (None if it loaded or was not
    tried yet)."""
    return _native_error


def _native_for(path: str, backend: str) -> Optional[ctypes.CDLL]:
    """The native library if `backend` takes it for this file, else None
    (the png path). Raises where the chosen path cannot decode the file."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown image backend {backend!r}: {BACKENDS}")
    if backend == "png" or (backend == "auto" and _is_png(path)):
        return None
    lib = _load_native()
    if lib is None:
        raise RuntimeError(
            f"cannot decode {path}: the native image loader (libjpeg and "
            f"libpng through g++) is unavailable ({_native_error}); only "
            "PNG files decode without it")
    return lib


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == png.SIGNATURE


# -- the numpy path -----------------------------------------------------------


def _taps(n_src: int, n_out: int):
    """Pillow's triangle filter along one axis, as csrc/imageloader.cpp's
    resample_axis builds it: (n_out, k) source indices and raw weights,
    zero-padded to k taps, and each output's weight total."""
    scale = n_src / n_out
    fscale = max(1.0, scale)
    support = fscale
    k = int(math.ceil(support)) * 2 + 2
    idx = np.zeros((n_out, k), np.int64)
    wts = np.zeros((n_out, k), np.float64)
    total = np.ones(n_out, np.float64)
    for o in range(n_out):
        center = (o + 0.5) * scale
        lo = max(int(math.floor(center - support)), 0)
        hi = min(int(math.ceil(center + support)), n_src)
        tot = 0.0
        for j, s in enumerate(range(lo, hi)):
            x = abs((s + 0.5 - center) / fscale)
            w = 1.0 - x if x < 1.0 else 0.0
            idx[o, j], wts[o, j] = s, w
            tot += w
        if tot <= 0.0:  # degenerate: nearest
            idx[o] = 0
            wts[o] = 0.0
            idx[o, 0] = min(max(int(center), 0), n_src - 1)
            wts[o, 0] = tot = 1.0
        total[o] = tot
    return idx, wts, total


def resample_axis(src: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """Resize a float32 image along `axis` (1: width, 0: height) with the
    native loader's filter: the taps are added in float64 in source order,
    then divided by their total and rounded to float32, as in C++."""
    idx, wts, total = _taps(src.shape[axis], n_out)
    acc = np.zeros((src.shape[0], n_out) if axis == 1
                   else (n_out, src.shape[1]), np.float64)
    for j in range(idx.shape[1]):
        if axis == 1:
            acc += src[:, idx[:, j]] * wts[None, :, j]
        else:
            acc += src[idx[:, j], :] * wts[:, j, None]
    tot = total[None, :] if axis == 1 else total[:, None]
    return (acc / tot).astype(np.float32)


def _png_gray_resize(path: str, long_side: int, df: int, tgt: int
                     ) -> LoadedImage:
    gray = png.to_gray(png.read_png(path))
    h0, w0 = gray.shape
    nw, nh = _resize_dims(w0, h0, long_side, df)
    if nw > tgt or nh > tgt:
        raise ValueError(f"{path}: resized {nw}x{nh} exceeds pad_to={tgt}")
    src = gray.astype(np.float32) / np.float32(255.0)
    dst = resample_axis(resample_axis(src, nw, axis=1), nh, axis=0)
    out = np.zeros((tgt, tgt), np.float32)
    out[:nh, :nw] = dst
    scale = np.array([w0 / nw, h0 / nh], dtype=np.float32)
    return LoadedImage(out, scale, (w0, h0), (nw, nh))


# -- the entry points ---------------------------------------------------------


def load_gray(
    path: str, long_side: int = 832, df: int = 8, pad_to: int | None = None,
    backend: str = "auto",
) -> LoadedImage:
    """Grayscale + Pillow-style triangle resize + zero-pad to a square.

    backend: "auto" (png for PNG files, native for the rest), "native"
    or "png" (see the module docstring)."""
    global last_backend
    tgt = pad_to if pad_to is not None else long_side
    lib = _native_for(path, backend)
    if lib is not None:
        out = np.zeros((tgt, tgt), dtype=np.float32)
        meta = np.zeros(4, dtype=np.int32)
        rc = lib.decode_gray_resize(
            path.encode(), long_side, df, tgt,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if rc != 0:
            raise RuntimeError(
                f"native image loader failed on {path} (rc={rc})")
        w0, h0, nw, nh = (int(v) for v in meta)
        last_backend = "native"
        scale = np.array([w0 / nw, h0 / nh], dtype=np.float32)
        return LoadedImage(out, scale, (w0, h0), (nw, nh))
    img = _png_gray_resize(path, long_side, df, tgt)
    last_backend = "png"
    return img


def _jpeg_size(f, path: str) -> Tuple[int, int]:
    """(W, H) from the first start-of-frame marker."""
    f.seek(2)
    while True:
        b = f.read(1)
        while b and b != b"\xff":
            b = f.read(1)
        while b == b"\xff":
            b = f.read(1)
        if not b:
            raise ValueError(f"{path}: no JPEG frame header")
        marker = b[0]
        if marker in (0x01,) or 0xD0 <= marker <= 0xD9:
            continue  # standalone markers carry no length
        head = f.read(2)
        if len(head) < 2:
            raise ValueError(f"{path}: truncated JPEG")
        n = struct.unpack(">H", head)[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            body = f.read(5)
            if len(body) < 5:
                raise ValueError(f"{path}: truncated JPEG frame header")
            h, w = struct.unpack(">HH", body[1:5])
            return w, h
        f.seek(n - 2, os.SEEK_CUR)


def image_size(path: str) -> Tuple[int, int]:
    """(W, H) of a PNG (IHDR) or JPEG (start of frame) from its header, as
    PIL's Image.size; no library needed."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == png.SIGNATURE:
            return png.png_size(head, path)
        if head[:2] == b"\xff\xd8":
            return _jpeg_size(f, path)
    raise ValueError(f"{path}: neither PNG nor JPEG")


def decode_rgb(path: str, backend: str = "auto") -> np.ndarray:
    """(H, W, 3) uint8 RGB at full resolution, as PIL's convert("RGB")."""
    global last_backend
    lib = _native_for(path, backend)
    if lib is not None:
        w, h = image_size(path)
        out = np.zeros((h, w, 3), np.uint8)
        wh = np.zeros(2, np.int32)
        rc = lib.decode_rgb(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.size, wh.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if rc != 0 or tuple(wh) != (w, h):
            raise RuntimeError(
                f"native image loader failed on {path} (rc={rc})")
        last_backend = "native"
        return out
    rgb = png.to_rgb(png.read_png(path))
    last_backend = "png"
    return rgb


def sample_colors(path: str, xys: np.ndarray,
                  backend: str = "auto") -> np.ndarray:
    """Nearest-pixel RGB at keypoint locations (COLMAP color extraction
    equivalent), rounded as the JAX package's sample_colors."""
    arr = decode_rgb(path, backend)
    h, w = arr.shape[:2]
    x = np.clip(np.round(xys[:, 0] - 0.5).astype(np.int64), 0, w - 1)
    y = np.clip(np.round(xys[:, 1] - 0.5).astype(np.int64), 0, h - 1)
    return arr[y, x]


def from_array(img: np.ndarray) -> LoadedImage:
    """A LoadedImage of an in-memory (H, W) float image in [0, 1], unscaled."""
    h, w = img.shape
    return LoadedImage(np.ascontiguousarray(img, dtype=np.float32),
                       np.ones(2, np.float32), (w, h), (w, h))
