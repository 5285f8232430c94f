"""Point-cloud accuracy / completeness against a ground-truth scan.

Port of the JAX package's eval/pointcloud.py, the ETH3D protocol:
  accuracy@tol     = fraction of reconstructed points within tol of the scan
  completeness@tol = fraction of scan points within tol of the reconstruction

Nearest neighbours are a blocked brute-force search on the device: one
(B, M) matrix of |q|^2 - 2 q.r + |r|^2 per block of queries, computed with
torch.matmul in float32 with TF32 off (core/precision.py; the JAX package
asks for Precision.HIGHEST), since the expansion cancels catastrophically at
reduced precision. The expansion only picks each query's nearest reference
point; its distance is then computed directly as |q - r|, so that the
cancellation (about an ulp of |q|^2, 1e-5 at coordinates of 10) cannot move
a distance across a tolerance between two devices.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..core.precision import geometry_precision
from ..device import resolve_device


def _block_min_dist(query: torch.Tensor, ref: torch.Tensor,
                    r2: torch.Tensor) -> torch.Tensor:
    """Squared distance from each query point to its nearest ref point.

    query (B, 3), ref (M, 3), r2 = |ref|^2 (M,) -> (B,)."""
    q2 = (query * query).sum(-1, keepdim=True)
    d2 = q2 - 2.0 * torch.matmul(query, ref.T) + r2[None, :]
    diff = query - ref[d2.argmin(-1)]
    return (diff * diff).sum(-1)


def nn_distances(query: np.ndarray, ref: np.ndarray, block: int = 4096,
                 device=None) -> np.ndarray:
    """Euclidean NN distance from each query point to ref, blocked on
    `device` (None means CUDA)."""
    dev = resolve_device(device)
    if len(ref) == 0:
        return np.full(len(query), np.inf)
    if len(query) == 0:
        return np.zeros(0)
    with geometry_precision():
        q = torch.as_tensor(np.asarray(query, np.float32), device=dev)
        r = torch.as_tensor(np.asarray(ref, np.float32), device=dev)
        r2 = (r * r).sum(-1)
        d2 = torch.cat([_block_min_dist(q[i:i + block], r, r2)
                        for i in range(0, len(q), block)])
    return np.sqrt(d2.cpu().numpy())


def accuracy_completeness(
    rec_points: np.ndarray,
    gt_points: np.ndarray,
    tolerances: Sequence[float] = (0.01, 0.02, 0.05),
    device=None,
) -> Dict[str, float]:
    """ETH3D-protocol accuracy/completeness at each tolerance (scene
    units), on `device` (None means CUDA)."""
    d_rec = nn_distances(rec_points, gt_points, device=device)
    d_gt = nn_distances(gt_points, rec_points, device=device)
    out: Dict[str, float] = {}
    for tol in tolerances:
        out[f"accuracy@{tol}"] = (float((d_rec <= tol).mean())
                                  if len(d_rec) else 0.0)
        out[f"completeness@{tol}"] = (float((d_gt <= tol).mean())
                                      if len(d_gt) else 0.0)
    return out
