"""Image loading, resizing and padding to a fixed square frame.

Port of `LoadedImage`, `_resize_dims` and the PIL path of `load_gray` from
the JAX package's data/images.py. PIL is imported only inside `load_gray`,
so the rest of the port runs where PIL is absent; the native C++ loader is
not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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


def load_gray(path: str, long_side: int = 832, df: int = 8,
              pad_to: int | None = None) -> LoadedImage:
    """Grayscale + bilinear resize + zero-pad to a square (needs PIL)."""
    from PIL import Image as PILImage

    tgt = pad_to if pad_to is not None else long_side
    img = PILImage.open(path).convert("L")
    w0, h0 = img.size
    nw, nh = _resize_dims(w0, h0, long_side, df)
    img = img.resize((nw, nh), PILImage.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    out = np.zeros((tgt, tgt), dtype=np.float32)
    out[:nh, :nw] = arr
    scale = np.array([w0 / nw, h0 / nh], dtype=np.float32)
    return LoadedImage(out, scale, (w0, h0), (nw, nh))


def from_array(img: np.ndarray) -> LoadedImage:
    """A LoadedImage of an in-memory (H, W) float image in [0, 1], unscaled."""
    h, w = img.shape
    return LoadedImage(np.ascontiguousarray(img, dtype=np.float32),
                       np.ones(2, np.float32), (w, h), (w, h))
