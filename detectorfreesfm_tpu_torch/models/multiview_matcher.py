"""Multiview track-refinement matcher.

Port of the JAX package's models/multiview_matcher.py (inference): for
every feature track, crop a patch around each node (`ops.roi_align.
extract_patches`, dilated per node by its relative scale), extract S2DNet
hypercolumn features from all T·V patches as one batch, run the
intra-track transformer (the reference patch against all query patches),
correlate the reference's center feature with each query window, and move
every query point by the soft-argmax expectation of that correlation.

`l2n` is x·rsqrt(Σx² + 1e-12), as in JAX, not `F.normalize`. With
`compute_dtype="bfloat16"` (JAX's bf16 path, models/layers.py) the patches,
S2DNet and the transformer run in bf16 on fp32 parameters; the
correlation and the expectation run on fp32 copies, as in JAX.

Under a torch profiler (utils/profiler.py) the forward records the spans
`refiner/s2dnet` and `refiner/transformer` (each the module's call), with
their device time, and the counters `refiner/chunks`, `refiner/slots`
(T x V node slots, from the shapes) and `refiner/live_slots` (the slots
`node_mask` keeps, summed on the device).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from ..device import compute_dtype
from ..ops.dsnt import soft_argmax_refine
from ..ops.roi_align import extract_patches
from ..utils.profiler import count, span
from .s2dnet import S2DNet
from .transformer import LocalFeatureTransformer


@dataclasses.dataclass(frozen=True)
class RefinerConfig:
    crop_size: int = 19    # image-pixel context window fed to the backbone
    window: int = 15       # feature window kept for attention/correlation
    d_model: int = 128
    nhead: int = 8
    n_layers: int = 2      # (self, cross) pairs
    softmax_temperature: float = 0.1
    # Reference-point movement: also search a (2r+1)^2 grid of candidate
    # reference positions and keep the one whose query heatmaps have the
    # smallest mean std. 0 = off.
    ref_move_radius: int = 0
    compute_dtype: str = "float32"  # or "bfloat16"; parameters stay fp32

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.compute_dtype)


class RefinerOutput(NamedTuple):
    coords: torch.Tensor  # (T, V, 2) refined coordinates, image pixels.
                          # View 0 only moves when ref_move_radius > 0.
    std: torch.Tensor     # (T, V) expectation std in window units (ref: 0)


def l2n(x):
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


class MultiviewRefiner(nn.Module):
    """Track refinement over a stack of images.

    forward(images (I, H, W, 1) float in [0, 1], node_img (T, V) int,
    node_xy (T, V, 2) (x, y) pixels with view 0 the track's reference,
    node_scale (T, V) relative patch scale, node_mask (T, V) bool)."""

    def __init__(self, cfg: RefinerConfig = RefinerConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = S2DNet(out_dim=cfg.d_model, compute_dtype=cfg.dtype)
        self.transformer = LocalFeatureTransformer(
            d_model=cfg.d_model, nhead=cfg.nhead,
            layer_names=("self", "cross") * cfg.n_layers,
            attention="linear", compute_dtype=cfg.dtype)

    def forward(self, images, node_img, node_xy, node_scale, node_mask
                ) -> RefinerOutput:
        cfg = self.cfg
        t, v = node_img.shape
        w = cfg.window
        c = cfg.d_model
        dev = images.device
        count("refiner/chunks", 1)
        count("refiner/slots", t * v)
        count("refiner/live_slots", lambda: node_mask.sum())

        # --- patch extraction + backbone (one dense batch) ------------------
        patches = extract_patches(
            images, node_xy.reshape(t * v, 2), node_img.reshape(t * v),
            cfg.crop_size, node_scale.reshape(t * v))   # (T*V, P, P, 1)
        with span("refiner/s2dnet", dev):
            feats = self.backbone(patches.to(cfg.dtype).permute(0, 3, 1, 2))
        off = (cfg.crop_size - w) // 2
        feats = feats[:, :, off:off + w, off:off + w]
        feats = feats.permute(0, 2, 3, 1).reshape(t, v, w * w, c)

        # --- intra-track transformer ----------------------------------------
        ref = feats[:, 0]                                    # (T, W2, C)
        qry = feats[:, 1:].reshape(t, (v - 1) * w * w, c)
        ref_mask = node_mask[:, 0:1].expand(t, w * w)
        qry_mask = node_mask[:, 1:].repeat_interleave(w * w, dim=1)
        with span("refiner/transformer", dev):
            ref, qry = self.transformer(ref, qry, ref_mask, qry_mask)

        # --- correlation + expectation ---------------------------------------
        qry = l2n(qry.reshape(t, v - 1, w * w, c).float())
        half = (w - 1) / 2.0
        r = cfg.ref_move_radius
        if r == 0:
            center = l2n(ref[:, (w * w) // 2].float())          # (T, C)
            sim = torch.einsum("tc,tqwc->tqw", center, qry)
            heat = sim.reshape(t, v - 1, w, w) / cfg.softmax_temperature
            coords_n, std = soft_argmax_refine(heat, normalized=True)
            delta = coords_n * half * node_scale[:, 1:, None]
            ref_xy = node_xy[:, 0:1]
        else:
            offs = torch.arange(-r, r + 1, device=node_xy.device)
            oy, ox = torch.meshgrid(offs, offs, indexing="ij")
            mid = w // 2
            cand_lin = ((mid + oy) * w + (mid + ox)).reshape(-1)  # (L2,)
            cand = l2n(ref[:, cand_lin].float())                  # (T, L2, C)
            sim = torch.einsum("tlc,tqwc->tlqw", cand, qry)
            heat = sim.reshape(t, -1, v - 1, w, w) / cfg.softmax_temperature
            coords_n, std_c = soft_argmax_refine(heat, normalized=True)
            # Best candidate = smallest mean std over valid query views
            qmask = node_mask[:, None, 1:].float()
            denom = torch.sum(qmask, -1).clamp_min(1.0)
            mean_std = torch.sum(std_c * qmask, -1) / denom       # (T, L2)
            best = torch.argmin(mean_std, dim=1)                  # (T,)
            rows = torch.arange(t, device=best.device)
            coords_n = coords_n[rows, best]
            std = std_c[rows, best]
            delta = coords_n * half * node_scale[:, 1:, None]
            d_ref = torch.stack([(best % (2 * r + 1)) - r,
                                 (best // (2 * r + 1)) - r], -1).float()
            ref_xy = (node_xy[:, 0] + d_ref)[:, None]

        q_xy = node_xy[:, 1:] + delta
        coords = torch.cat([ref_xy, q_xy], dim=1)
        std_full = torch.cat([torch.zeros_like(std[:, :1]), std], dim=1)
        # Masked nodes keep their input coordinates
        coords = torch.where(node_mask[..., None], coords, node_xy)
        return RefinerOutput(coords, std_full)
