"""Image loading, resizing and padding to a fixed square frame, without PIL.

Port of the JAX package's data/images.py. `load_gray` decodes through one
of two backends, neither of which needs a system library:

  * "png": data/png.py (zlib, with the row filters undone in C++) and a
    numpy resize with the JAX native loader's arithmetic (Pillow's
    triangle filter in double precision), which adds in the same order
    and gives the same floats.
  * "jpeg": csrc/jpeg.cpp, a self-contained baseline and progressive JPEG
    decoder (standard C++ only, built with g++ at first use into the
    gitignored build/native/ at the repo root), whose luma and RGB equal
    libjpeg's bit for bit, and which resizes with the same arithmetic in
    C++.

"auto" reads PNG files with the png path and JPEG files with the jpeg
path, and refuses anything else with ValueError naming the file (the
JAX package's native loader, libjpeg and libpng, reads nothing more).
ctypes and zlib release the GIL, so a thread pool decodes in parallel on
both paths. `last_backend` names the backend that decoded the last image
(threads share it, so read it after a run). `image_size` reads (W, H)
from a PNG or JPEG header in Python; `decode_rgb`, `sample_colors` and
`load_rgb_mean_color` give colours as the JAX package's PIL path does
(PIL's convert("RGB")).
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

JPEG_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "jpeg.cpp"
BACKENDS = ("auto", "png", "jpeg")
JPEG_SIGNATURE = b"\xff\xd8"

_lock = threading.Lock()
_jpeg_lib: Optional[ctypes.CDLL] = None
_jpeg_error: Optional[str] = None
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


def _backend_for(path: str, backend: str) -> str:
    """The backend that decodes `path`: "png" or "jpeg" (see the module
    docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown image backend {backend!r}: {BACKENDS}")
    if backend != "auto":
        return backend
    with open(path, "rb") as f:
        head = f.read(8)
    if head == png.SIGNATURE:
        return "png"
    if head[:2] == JPEG_SIGNATURE:
        return "jpeg"
    raise ValueError(f"{path}: neither PNG nor JPEG")


# -- the JPEG decoder ---------------------------------------------------------


def jpeg_library_path() -> Path:
    """build/native/libjpeg_<hash of source and flags>.so"""
    return native.library_path(JPEG_SOURCE)


def _load_jpeg() -> Optional[ctypes.CDLL]:
    """Build (once) and load csrc/jpeg.cpp; None if g++ or the load fails
    (the reason stays in jpeg_error())."""
    global _jpeg_lib, _jpeg_error
    with _lock:
        if _jpeg_lib is not None or _jpeg_error is not None:
            return _jpeg_lib
        try:
            lib = native.build(JPEG_SOURCE)
            u8, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(
                ctypes.c_int)
            for fn in (lib.jpeg_gray, lib.jpeg_rgb):
                fn.argtypes = [ctypes.c_char_p, u8, ctypes.c_long, ip,
                               ctypes.c_char_p, ctypes.c_int]
                fn.restype = ctypes.c_int
            lib.jpeg_gray_resize.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ip, ctypes.c_char_p,
                ctypes.c_int]
            lib.jpeg_gray_resize.restype = ctypes.c_int
            _jpeg_lib = lib
        except native.BUILD_ERRORS as e:
            _jpeg_error = f"{type(e).__name__}: {e}"
        return _jpeg_lib


def jpeg_error() -> Optional[str]:
    """Why the JPEG decoder is unavailable (None if it loaded or was not
    tried yet)."""
    return _jpeg_error


def _jpeg_call(fn_name: str, path: str, *args) -> None:
    """Call one of csrc/jpeg.cpp's entry points; a refused or unreadable
    file raises ValueError naming the file and the reason."""
    lib = _load_jpeg()
    if lib is None:
        raise RuntimeError(
            f"cannot decode {path}: the JPEG decoder (csrc/jpeg.cpp through "
            f"g++) is unavailable ({_jpeg_error})")
    err = ctypes.create_string_buffer(256)
    if getattr(lib, fn_name)(path.encode(), *args, err, len(err)) != 0:
        raise ValueError(f"{path}: {err.value.decode()}")


def _jpeg_plane(path: str, rgb: bool) -> np.ndarray:
    """(H, W) uint8 luma, or (H, W, 3) uint8 RGB, at full resolution."""
    w, h = image_size(path)
    out = np.zeros((h, w, 3) if rgb else (h, w), np.uint8)
    wh = np.zeros(2, np.int32)
    _jpeg_call("jpeg_rgb" if rgb else "jpeg_gray", path,
               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
               wh.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if tuple(wh) != (w, h):
        raise ValueError(f"{path}: frame size {tuple(wh)} differs from the "
                         f"header's {(w, h)}")
    return out


# -- the numpy path -----------------------------------------------------------


def _taps(n_src: int, n_out: int):
    """Pillow's triangle filter along one axis, as the JAX package's
    native/imageloader.cpp builds it (resample_axis): (n_out, k) source
    indices and raw weights, zero-padded to k taps, and each output's
    weight total."""
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
    JAX native loader's filter: the taps are added in float64 in source
    order, then divided by their total and rounded to float32, as in
    C++."""
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

    backend: "auto" (png for PNG files, jpeg for JPEG files), "png" or
    "jpeg" (see the module docstring)."""
    global last_backend
    tgt = pad_to if pad_to is not None else long_side
    kind = _backend_for(path, backend)
    if kind == "png":
        img = _png_gray_resize(path, long_side, df, tgt)
        last_backend = "png"
        return img
    out = np.zeros((tgt, tgt), dtype=np.float32)
    meta = np.zeros(4, dtype=np.int32)
    _jpeg_call("jpeg_gray_resize", path, long_side, df, tgt,
               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    w0, h0, nw, nh = (int(v) for v in meta)
    last_backend = "jpeg"
    scale = np.array([w0 / nw, h0 / nh], dtype=np.float32)
    return LoadedImage(out, scale, (w0, h0), (nw, nh))


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
    kind = _backend_for(path, backend)
    if kind == "png":
        rgb = png.to_rgb(png.read_png(path))
    else:
        rgb = _jpeg_plane(path, rgb=True)
    last_backend = kind
    return rgb


def load_rgb_mean_color(path: str, backend: str = "auto") -> np.ndarray:
    """Mean RGB of the image (used for cheap 3D-point color extraction)."""
    return np.asarray(decode_rgb(path, backend), dtype=np.float32
                      ).reshape(-1, 3).mean(0)


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
