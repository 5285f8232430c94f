"""Explicit device resolution (the GPU unless told otherwise), and the
fp32 backend settings of the matcher."""

from __future__ import annotations

import re

import torch

# Messages of the errors that the card or its libraries raise, as opposed
# to those of the program or its data.
_DEVICE_ERROR = re.compile(
    r"CUDA error|out of memory|cusolver|cublas|cudnn|cufft|curand",
    re.IGNORECASE)


def resolve_device(device=None) -> torch.device:
    """None means "cuda". A CUDA device without CUDA raises; there is no
    silent fallback to the CPU (tests pass device="cpu")."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def is_device_error(e: BaseException) -> bool:
    """Whether an exception is a fault of the card or its libraries (a
    CUDA, cuBLAS, cuSOLVER or cuDNN error, or device memory run out)."""
    if isinstance(e, torch.cuda.OutOfMemoryError) or type(
            e).__name__ == "AcceleratorError":
        return True
    return isinstance(e, RuntimeError) and bool(_DEVICE_ERROR.search(str(e)))


def set_fp32_backends() -> None:
    """Full-fp32 matmuls and cuDNN convolutions, with timed algorithms.

    torch runs fp32 convolutions in TF32 by default, and at the
    dual-softmax's 1/T = 10 logit scale TF32's ~3 decimal digits are enough
    to flip matches, so the fp32 matcher turns it off for both. Without
    TF32, cuDNN's heuristic picks an FFT convolution for the backbone that
    runs as ~165k tiny complex GEMMs (88% of an 832 px batch on an H100,
    PERF.md); benchmark mode times the algorithms once per shape instead."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
