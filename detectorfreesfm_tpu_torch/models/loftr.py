"""Detector-free coarse(+fine) matcher, the LoFTR-class model.

Port of `MatcherConfig`, `MatchOutput`, `FinePreprocessAndMatch` and
`DetectorFreeMatcher` from the JAX package's models/loftr.py: ResNet-FPN
features, sine position encoding, the linear-attention coarse transformer,
dual-softmax + mutual-NN matching (dense, or fused through the CUDA kernels
of ops/fused_dsm.py), and the optional 5x5-window fine stage with
soft-argmax. Images enter NHWC (B, H, W, 1) in [0, 1], as in JAX; matches
leave as fixed-capacity top-K sets in network-input pixels. The training
paths are JAX's too: `return_conf` also returns the dense (B, L, S)
confidence (and forces the dense path), and `fine_at` runs the same fine
head at teacher-forced coarse cells. `PairMatcher` is the two-stage
contract every matcher family keeps: here the per-image stage
(`encode_views`) is the backbone and the position encoding, into
ViewFeatures, and the pair stage (`match_views`) the rest; `forward` is
their composition, and the engine computes each view once per call.

`compute_dtype="bfloat16"` is JAX's bf16 path (models/layers.py): fp32
parameters; the image, backbone, position encoding and both transformers
in bf16; matching on fp32 copies of the coarse features (dense and fused
alike), and the fine window's correlation and soft-argmax in fp32.

The TPU kernel's tile sizes (`dsm_tile_l/s`) have no counterpart here.

Under a torch profiler (utils/profiler.py) the forward records the spans
`matcher/backbone`, `matcher/coarse_transformer` (each the module's
call), `matcher/dual_softmax` (the confidence and the top-K extraction,
dense or fused) and `matcher/fine` (the fine stage at the matches), with
their device time.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from ..device import compute_dtype, set_backends
from ..ops.dsnt import soft_argmax_refine
from ..ops.dual_softmax import (
    CoarseMatches,
    border_mask,
    dual_softmax_confidence,
    extract_topk_matches,
)
from ..ops.fused_dsm import fused_extract_matches
from ..utils.profiler import span
from .backbone import ResNetFPN_8_2
from .position_encoding import add_position_encoding
from .transformer import LocalFeatureTransformer


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    d_coarse: int = 256
    d_fine: int = 128
    nhead: int = 8
    n_coarse_layers: int = 4  # (self, cross) pairs
    match_threshold: float = 0.2
    dsoftmax_temperature: float = 0.1
    border: int = 2  # border cells removed from matching
    max_matches: int = 2048  # static top-K capacity per pair
    fine_window: int = 5  # fine correlation window (fine-res px)
    fine_enabled: bool = False
    compute_dtype: str = "float32"  # or "bfloat16"; parameters stay fp32
    # Fused dual-softmax + mutual-NN extraction through the CUDA kernels
    # (ops/fused_dsm.py): never materialises the (L, S) conf matrix.
    fused_matching: bool = False
    # Schraudolph exp on the kernel's lse exp terms (±3% on the normaliser).
    dsm_fast_exp: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.compute_dtype)


class ViewFeatures(NamedTuple):
    """What the matcher's per-image stage gives for N views."""

    coarse: torch.Tensor   # (N, h8 * w8, C) position-encoded, 1/8 grid
    fine: torch.Tensor     # (N, H/2, W/2, C_f) NHWC


class MatchOutput(NamedTuple):
    """Batch of fixed-capacity matches in network-input pixel coordinates."""

    coords0: torch.Tensor  # (B, K, 2) float32 (x, y) in image0
    coords1: torch.Tensor  # (B, K, 2)
    conf: torch.Tensor     # (B, K)
    valid: torch.Tensor    # (B, K) bool


def grid_valid(valid_hw, b: int, h8: int, w8: int, border: int, device):
    """(B, h8 * w8) bool: the coarse cells that may match, `border` cells
    in from the frame's edge, or from each pair's live region (valid_hw,
    (B, 2) int (h, w) at full res) where one is given."""
    if valid_hw is None:
        return border_mask(h8, w8, border, device=device)[None].expand(b, -1)
    vs = torch.as_tensor(valid_hw, device=device) // 8
    return border_mask(h8, w8, border, vs[:, 0], vs[:, 1], device=device)


def cells_to_xy(idx, w8: int):
    """Flat 1/8 grid cells -> full-res pixels (the cell's top-left * 8)."""
    return torch.stack([(idx % w8).float() * 8.0,
                        (idx // w8).float() * 8.0], dim=-1)


def dense_match(c0, c1, mask0, mask1, cfg, w8: int,
                return_conf: bool = False):
    """Dense dual-softmax + mutual-NN top-K on fp32 copies of the coarse
    features (B, L, C): the MatchOutput, and the (B, L, S) confidence too
    with `return_conf`. The head of the coarse-only matchers."""
    conf = dual_softmax_confidence(c0.float(), c1.float(), mask0, mask1,
                                   cfg.dsoftmax_temperature)
    m = extract_topk_matches(conf, cfg.match_threshold, cfg.max_matches)
    out = MatchOutput(cells_to_xy(m.idx0, w8), cells_to_xy(m.idx1, w8),
                      m.conf, m.valid)
    return (out, conf) if return_conf else out


class FinePreprocessAndMatch(nn.Module):
    """5x5-window fine refinement of image1 coordinates at coarse matches."""

    def __init__(self, cfg: MatcherConfig):
        super().__init__()
        self.cfg = cfg
        self.fine_transformer = LocalFeatureTransformer(
            d_model=cfg.d_fine, nhead=cfg.nhead, layer_names=("self", "cross"),
            attention="linear", compute_dtype=cfg.dtype)

    def forward(self, fine0, fine1, matches: CoarseMatches, w8: int):
        """fine0/1: (B, H/2, W/2, C_f) NHWC; matches index the 1/8 grids.
        Returns the full-res (dx, dy) offset of image1's point and the std."""
        w = self.cfg.fine_window
        half = w // 2
        b, k = matches.idx0.shape
        c = fine0.shape[-1]
        off = torch.arange(-half, half + 1, device=fine0.device)

        def windows(fine, idx):
            # Clamped gather of w*w windows centred at 4 * (coarse cell).
            hf, wf = fine.shape[1:3]
            idx = idx.long()
            cy = (idx // w8) * 4
            cx = (idx % w8) * 4
            yy = (cy[..., None, None] + off[:, None]).clamp(0, hf - 1)
            xx = (cx[..., None, None] + off[None, :]).clamp(0, wf - 1)
            lin = (yy * wf + xx).reshape(b, k * w * w, 1).expand(-1, -1, c)
            out = torch.gather(fine.reshape(b, hf * wf, c), 1, lin)
            return out.reshape(b * k, w * w, c)

        f0, f1 = self.fine_transformer(windows(fine0, matches.idx0),
                                       windows(fine1, matches.idx1))
        # Correlate the centre of window0 against all of window1.
        center = f0[:, (w * w) // 2]
        sim = torch.einsum("nc,nwc->nw", center.float(), f1.float())
        sim = sim / float(c) ** 0.5
        coords, std = soft_argmax_refine(sim.reshape(b, k, w, w),
                                         temperature=1.0, normalized=True)
        delta_fine = coords * half  # fine-res px offset
        return delta_fine * 2.0, std  # full-res px


class PairMatcher(nn.Module):
    """A matcher in two stages, the contract of every family and all that
    the engine (match/engine.py) knows of one: `encode_views`, per image,
    (N, H, W, 1) frames in [0, 1] to the family's views (a NamedTuple of
    tensors with a leading view axis); `view_bytes(h, w)`, the bytes of
    one view at an h x w frame; `match_views(view0, view1, valid_hw0,
    valid_hw1, return_conf, ...)`, per pair. `forward` is their
    composition."""

    def forward(self, image0, image1, valid_hw0=None, valid_hw1=None,
                return_conf: bool = False, **pair_args):
        """image0/1: (B, H, W, 1) in [0, 1], or the views of B views each
        (`encode_views`); valid_hw: (B, 2) int (h, w) live region at full
        res, optional. Frames run through the per-image stage in one batch
        of 2B, then `match_views` matches the two sides, with the family's
        own `pair_args` (LoFTR's `fine_at`). Returns the MatchOutput, and
        the dense (B, L, S) confidence too with `return_conf`."""
        if isinstance(image0, torch.Tensor):
            b = image0.shape[0]
            views = self.encode_views(torch.cat([image0, image1], dim=0))
            image0 = type(views)(*(v[:b] for v in views))
            image1 = type(views)(*(v[b:] for v in views))
        return self.match_views(image0, image1, valid_hw0, valid_hw1,
                                return_conf, **pair_args)


class DetectorFreeMatcher(PairMatcher):
    """Full matcher: images in, fixed-capacity subpixel matches out.

    The fine head is always built, so a checkpoint converts the same way
    whatever `fine_enabled` says; it runs only when enabled."""

    def __init__(self, cfg: MatcherConfig = MatcherConfig()):
        super().__init__()
        # TF32 off for convs and matmuls (it flips matches at 1/T = 10),
        # bf16 GEMMs reduced in fp32, and cuDNN's algorithm choice; set
        # where the model is built (device.py).
        set_backends(cfg.compute_dtype)
        self.cfg = cfg
        self.backbone = ResNetFPN_8_2(compute_dtype=cfg.dtype)
        self.coarse_transformer = LocalFeatureTransformer(
            d_model=cfg.d_coarse, nhead=cfg.nhead,
            layer_names=("self", "cross") * cfg.n_coarse_layers,
            attention="linear", compute_dtype=cfg.dtype)
        self.fine_match = FinePreprocessAndMatch(cfg)

    def encode_views(self, images) -> ViewFeatures:
        """The per-image stage: (N, H, W, 1) frames in [0, 1] to their
        ViewFeatures. Nothing in it reads another image (the backbone's
        BatchNorm is in inference mode), so a view's features serve every
        pair it belongs to."""
        x = images.to(self.cfg.dtype).permute(0, 3, 1, 2)
        with span("matcher/backbone", images.device):
            coarse, fine = self.backbone(x)
        n, _, h8, w8 = coarse.shape
        coarse = add_position_encoding(coarse.permute(0, 2, 3, 1))
        return ViewFeatures(coarse.reshape(n, h8 * w8, -1),
                            fine.permute(0, 2, 3, 1))

    def view_bytes(self, h: int, w: int) -> int:
        """Bytes of one view's ViewFeatures at an h x w frame."""
        cfg = self.cfg
        return ((h // 8) * (w // 8) * cfg.d_coarse
                + (h // 2) * (w // 2) * cfg.d_fine) * cfg.dtype.itemsize

    def match_views(self, view0: ViewFeatures, view1: ViewFeatures,
                    valid_hw0=None, valid_hw1=None,
                    return_conf: bool = False, fine_at=None):
        """The pair stage: the masks, the coarse transformer, the
        dual-softmax and the fine stage over the two sides' ViewFeatures
        (B views each); arguments and outputs as `forward`'s. With
        `fine_at`, (idx0, idx1) int (B, Kf) coarse cells, the fine head's
        (delta, std) there come back too: out[, conf][, (delta, std)], as
        in JAX."""
        cfg = self.cfg
        c0, c1 = view0.coarse, view1.coarse
        dev = c0.device
        b = c0.shape[0]
        h8, w8 = view0.fine.shape[1] // 4, view0.fine.shape[2] // 4

        mask0 = grid_valid(valid_hw0, b, h8, w8, cfg.border, dev)
        mask1 = grid_valid(valid_hw1, b, h8, w8, cfg.border, dev)
        with span("matcher/coarse_transformer", dev):
            c0, c1 = self.coarse_transformer(c0, c1, mask0, mask1)

        conf = None
        with span("matcher/dual_softmax", dev):
            if cfg.fused_matching and not return_conf:
                matches = fused_extract_matches(
                    c0, c1, mask0, mask1, cfg.match_threshold,
                    cfg.max_matches, temperature=cfg.dsoftmax_temperature,
                    fast_exp=cfg.dsm_fast_exp)
            else:
                conf = dual_softmax_confidence(
                    c0.float(), c1.float(), mask0, mask1,
                    cfg.dsoftmax_temperature)
                matches = extract_topk_matches(conf, cfg.match_threshold,
                                               cfg.max_matches)

        xy0 = cells_to_xy(matches.idx0, w8)
        xy1 = cells_to_xy(matches.idx1, w8)
        if cfg.fine_enabled:
            with span("matcher/fine", dev):
                delta, _std = self.fine_match(view0.fine, view1.fine,
                                              matches, w8)
            xy1 = xy1 + delta
        out = MatchOutput(xy0, xy1, matches.conf, matches.valid)
        extra = (conf,) if return_conf else ()
        if fine_at is not None:
            # The teacher-forced pass reuses the inference fine head, so a
            # jointly trained checkpoint serves both.
            t_idx0, t_idx1 = fine_at
            teacher = CoarseMatches(
                t_idx0, t_idx1, torch.ones(t_idx0.shape, device=t_idx0.device),
                torch.ones(t_idx0.shape, dtype=torch.bool,
                           device=t_idx0.device))
            extra += (self.fine_match(view0.fine, view1.fine, teacher, w8),)
        return (out,) + extra if extra else out
