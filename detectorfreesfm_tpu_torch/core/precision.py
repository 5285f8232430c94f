"""Matmul precision of geometry code.

Counterpart of the JAX package's core/precision.py, which traces every
geometry kernel under HIGHEST matmul precision: design matrices, Gauss-Newton
steps and Schur reductions visibly lose registrations and convergence at
reduced precision. In the port geometry runs in float32 with TF32 off (and
in float64 only where the JAX package uses numpy float64). Each geometry
entry point runs under `geometry_precision()` itself, so the setting holds
whether or not a matcher was built first, and restores the caller's
settings on return, so geometry never decides the matcher's precision.

The JAX module's device hopping (batched kernels on the accelerator,
latency-bound ones on the host) has no counterpart: the port runs geometry
on the device the caller passes. Two helpers the geometry modules share
live here too: `as_tensor` and `eigh` (batched, chunked for cuSOLVER).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def geometry_precision():
    """Full-fp32 matmuls (TF32 off for cuBLAS and cuDNN, highest fp32
    precision) for the duration; the previous settings are restored after.
    Also a decorator: `@geometry_precision()`."""
    matmul = torch.get_float32_matmul_precision()
    cuda_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        # allow_tf32 and the matmul precision are one setting in torch:
        # the flag first, so that "medium" survives the round trip.
        torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor on `device` (dtype kept unless given)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)


# cuSOLVER's batched symmetric eigensolver, as torch 2.11 with CUDA 12.8
# calls it on an H100, refuses batches of 40 000 or more small matrices
# (4x4 and 12x12) with CUSOLVER_STATUS_INVALID_VALUE; batches of 16 384
# run. Each matrix is solved on its own, so chunking changes no result.
EIGH_MAX_BATCH = 16384


def eigh(A: torch.Tensor):
    """torch.linalg.eigh over any batch: above EIGH_MAX_BATCH matrices it
    runs in near-equal chunks of at most that many."""
    n = A.shape[:-2].numel()
    if n <= EIGH_MAX_BATCH:
        return torch.linalg.eigh(A)
    flat = A.reshape(n, *A.shape[-2:])
    parts = [torch.linalg.eigh(c) for c in
             flat.tensor_split(-(-n // EIGH_MAX_BATCH))]
    w = torch.cat([p[0] for p in parts]).reshape(*A.shape[:-1])
    v = torch.cat([p[1] for p in parts]).reshape(A.shape)
    return w, v
