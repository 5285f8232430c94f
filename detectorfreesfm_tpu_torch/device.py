"""Explicit device resolution (the GPU unless told otherwise), the
compute dtypes, and the backend settings of the matcher for each."""

from __future__ import annotations

import re
from contextlib import contextmanager

import torch

# The JAX package's `compute_dtype` names. Its configs map any other name
# to float32; here another name raises, so that a bf16 request never runs
# in fp32 unnoticed.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# How many of cuDNN's heuristic's algorithms benchmark mode times per
# convolution shape (see set_fp32_backends). bf16 keeps torch's default:
# with 3 or 1 algorithms timed, or the heuristic alone, its first batch is
# 2-5 s cheaper, but the convolutions round differently and up to 6% of
# the matches change (tools/cudnn_modes.py).
FP32_BENCHMARK_LIMIT = 3
BF16_BENCHMARK_LIMIT = 10

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
    TF32, cuDNN's heuristic once picked an FFT convolution for the backbone
    that ran as ~165k tiny complex GEMMs (88% of an 832 px batch on an
    H100, PERF.md), so cuDNN times its algorithms once per shape
    (benchmark mode), but only its heuristic's first FP32_BENCHMARK_LIMIT:
    timing all of them (torch's limit, 10) cost 27.5 s in the first 832 px
    batch and 169.7 s at 1600 px, against 3.7 and 9.6 s with 3, for the
    same warm speed and the same matches (tools/cudnn_modes.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.benchmark_limit = FP32_BENCHMARK_LIMIT


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a `compute_dtype` name ("float32" or
    "bfloat16"); any other name raises."""
    try:
        return COMPUTE_DTYPES[name]
    except KeyError:
        raise ValueError(f"compute_dtype {name!r} is not one of "
                         f"{sorted(COMPUTE_DTYPES)}") from None


def set_bf16_backends() -> None:
    """The bf16 path's settings: those of fp32, since its softmax,
    correlation and expectation products run in full fp32 as in JAX, and
    bf16 GEMMs reduced in fp32. torch lets cuBLAS reduce a bf16 GEMM in
    bf16 by default; XLA reduces in fp32 (flax's Dense and Conv return
    bf16 that was accumulated in fp32)."""
    set_fp32_backends()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.benchmark_limit = BF16_BENCHMARK_LIMIT


def set_backends(dtype: str) -> None:
    """set_fp32_backends or set_bf16_backends, by `compute_dtype` name."""
    if compute_dtype(dtype) == torch.bfloat16:
        set_bf16_backends()
    else:
        set_fp32_backends()


@contextmanager
def bf16_reduced_in_fp32():
    """bf16 GEMMs reduced in fp32 for the duration (see set_bf16_backends);
    the caller's setting is restored after."""
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            prev)
