"""Training losses.

Port of the JAX package's train/losses.py:

  * coarse_focal_loss: focal binary cross-entropy of the dual-softmax
    confidence against a ground-truth assignment (positives vs. every other
    cell of a live row);
  * fine_l2_std_loss: the refiner's L2-with-std objective, masked
    ‖pred − gt‖² weighted by the detached, batch-normalised inverse std.

All reductions in float32. The focal loss gathers the positive cells
instead of materialising JAX's (B, L, S) one-hot: the sums are the same.
"""

from __future__ import annotations

import torch


def coarse_focal_loss(conf, gt_idx1, valid_rows=None, alpha: float = 0.25,
                      gamma: float = 2.0, eps: float = 1e-20):
    """conf (B, L, S) in [0, 1]; gt_idx1 (B, L) int, the column of each
    row's match or -1; valid_rows (B, L) bool, optional. A scalar.

    eps only guards log(0): the random-init dual-softmax product is
    ~(1/L)^2, far above it."""
    b, l, s = conf.shape
    # jnp.clip's gradient: halved where the value sits on a bound (the
    # masked cells, at 0), as torch.maximum/minimum give it; clamp's not.
    conf = conf.float()
    conf = torch.minimum(torch.maximum(conf, conf.new_zeros(())),
                         conf.new_full((), 1.0 - 1e-6))
    gt_idx1 = gt_idx1.long()
    matched = gt_idx1 >= 0
    if valid_rows is not None:
        matched = matched & valid_rows
    live = (valid_rows.float() if valid_rows is not None
            else torch.ones((b, l), device=conf.device))
    mf = matched.float()
    c_pos = torch.gather(conf, 2, gt_idx1.clamp(0, s - 1)[..., None])[..., 0]

    def pos_w(c):
        return alpha * (1.0 - c) ** gamma * (-torch.log(c + eps))

    def neg_w(c):
        return (1.0 - alpha) * c ** gamma * (-torch.log(1.0 - c + eps))

    n_pos = torch.sum(mf)
    loss_pos = torch.sum(mf * pos_w(c_pos)) / torch.clamp_min(n_pos, 1.0)
    # Negatives: every cell of a live row but its positive.
    neg_rows = torch.sum(neg_w(conf), dim=2)
    neg_sum = torch.sum(live * neg_rows) - torch.sum(mf * neg_w(c_pos))
    n_neg = torch.sum(live) * s - n_pos
    return loss_pos + neg_sum / torch.clamp_min(n_neg, 1.0)


def fine_l2_std_loss(pred, gt, std, mask, eps: float = 1e-9):
    """pred/gt (..., 2), std (...), mask (...) bool. Weight = 1/std
    normalised to mean 1 over the valid set and detached; the loss is the
    mean weighted ‖pred − gt‖² over the valid set."""
    mask_f = mask.float()
    inv_std = 1.0 / torch.clamp_min(std.float(), 1e-3)
    denom = torch.clamp_min(torch.sum(mask_f), 1.0)
    weight = (inv_std / (torch.sum(inv_std * mask_f) / denom + eps)).detach()
    # Mask before squaring: out-of-frame targets can be inf, and inf * 0
    # would poison the sum and its gradient with NaN.
    diff = torch.where(mask[..., None], pred.float() - gt.float(),
                       torch.zeros((), device=pred.device))
    err2 = torch.sum(diff * diff, -1)
    return torch.sum(weight * err2 * mask_f) / denom
