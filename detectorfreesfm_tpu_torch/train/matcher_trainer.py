"""Coarse(+fine) matcher trainer: focal-loss training of the detector-free
matcher on depth-warped cell labels.

Port of the JAX package's train/matcher_trainer.py, data-parallel over a
device mesh and over processes as train/trainer.py (rows padded to the
mesh's "data" rows with copies of row 0 that `live` masks out, the masked
batch mean, gradients summed over the group's processes). The coarse loss is the focal loss of the dense dual-softmax confidence against
`pair_cell_assignment`'s labels (made on the device); with
`matcher.fine_enabled` the fine head is also teacher-forced at `n_fine` GT
cells per pair (picked by a multiplicative-hash tiebreak that spreads them
over the image) and supervised on the sub-cell residual. As in JAX the
model is applied with BatchNorm on its running statistics, which get
gradients like every other leaf. The fused dual-softmax kernels are off
this path: the loss needs the dense confidence (`return_conf`).

With `matcher.compute_dtype="bfloat16"` the forward runs in bf16 as JAX's
does (models/loftr.py); the loss still reads the fp32 dense confidence,
and parameters, gradients and Adam's state stay fp32.

`arch` "aspan" or "matchformer" trains that family of models.build_matcher
(built as JAX builds it: threshold, capacity and compute dtype from
`matcher`) with the same coarse focal loss on its dense confidence. Those
models have no fine stage: JAX's trainer fails at its first step with
`fine_enabled` (the model takes no `fine_at`), and this one refuses the
config when it is constructed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import LOFTR_FAMILY, build_matcher
from ..models.loftr import DetectorFreeMatcher, MatcherConfig
from ..parallel.mesh import mesh_of, pad_to_multiple
from ..parallel.orchestrate import broadcast_from_first
from ..utils import checkpoint
from .losses import coarse_focal_loss, fine_l2_std_loss
from .matcher_supervision import pair_cell_assignment
from .optimizers import OptimConfig, build_optimizer
from .supervision import stable_top_k
from .trainer import (TrainState, as_device, data_parallel_value_and_grad,
                      init_leaves, live_rows, pad_rows)

@dataclasses.dataclass(frozen=True)
class MatcherTrainConfig:
    arch: str = "loftr"  # loftr | aspan | matchformer (build_matcher)
    matcher: MatcherConfig = MatcherConfig()
    optim: OptimConfig = OptimConfig(backbone_path="backbone")
    grid: int = 8
    seed: int = 66  # the reference's matcher-build seed
    n_fine: int = 128
    fine_loss_weight: float = 1.0



def fine_cells(gt, n_fine: int):
    """The n_fine rows to teacher-force: valid rows first, each row's
    multiplicative hash ((i * 2654435761) mod 2^16) / 2^16 breaking the
    order (JAX's top_k of valid + tie)."""
    idx = torch.arange(gt.shape[0], dtype=torch.int64, device=gt.device)
    tie = ((idx * 2654435761) % 65536).float() / 65536.0
    return stable_top_k((gt >= 0).float() + tie, min(n_fine, gt.shape[0]))


class MatcherTrainer:
    """The matcher, its optimizer, the step and checkpoint IO, on `mesh`
    or a one-entry mesh of `device` (neither: the default mesh, which
    needs CUDA); the state lives on the mesh's first device. `history`
    holds each step's loss and gradient norm."""

    def __init__(self, cfg: MatcherTrainConfig = MatcherTrainConfig(),
                 device=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh_of(device, mesh)
        self.device = self.mesh.first
        mc = cfg.matcher
        if cfg.arch in LOFTR_FAMILY:
            self.model = DetectorFreeMatcher(mc)
            # flax builds no fine head unless the fine stage is on.
            self.exclude = () if mc.fine_enabled else (
                checkpoint.FINE_PREFIX,)
        else:
            if mc.fine_enabled:
                raise ValueError(
                    f"matcher arch {cfg.arch!r} has no fine stage: train it "
                    f"without the fine stage (--fine)")
            self.model = build_matcher(
                cfg.arch, match_threshold=mc.match_threshold,
                max_matches=mc.max_matches, compute_dtype=mc.compute_dtype)
            self.exclude = ()
        self.history = []

    def init_state(self, sample_batch=None) -> TrainState:
        params = init_leaves(self.model, self.cfg.seed, self.device,
                             self.exclude)
        broadcast_from_first(list(params.values()))
        return TrainState(params, build_optimizer(self.cfg.optim, params), 0)

    def loss_one(self, apply, image0, image1, gt, uv1):
        """Loss of ONE pair: image (H, W, 1), gt (L,), uv1 (L, 2)."""
        cfg = self.cfg
        if not cfg.matcher.fine_enabled:
            _, conf = apply(image0[None], image1[None], return_conf=True)
            return coarse_focal_loss(conf, gt[None])
        w8 = image0.shape[1] // cfg.grid
        sel = fine_cells(gt, cfg.n_fine)
        idx1 = torch.clamp_min(gt[sel].long(), 0)
        _, conf, (delta, std) = apply(
            image0[None], image1[None], return_conf=True,
            fine_at=(sel[None], idx1[None]))
        coarse = coarse_focal_loss(conf, gt[None])
        # GT sub-cell residual over the fine half-window (4 px); cells are
        # top-left * grid, the model's own keypoints.
        cell_xy1 = torch.stack([(idx1 % w8).float() * cfg.grid,
                                (idx1 // w8).float() * cfg.grid], -1)
        off = (uv1[sel] - cell_xy1) / 4.0
        m = (gt[sel] >= 0) & (torch.amax(torch.abs(off), -1) < 1.0)
        fine = fine_l2_std_loss(delta[0] / 4.0, off, std[0], m)
        return coarse + cfg.fine_loss_weight * fine

    def supervise(self, batch):
        """Cell labels and warp targets of each pair, on the device."""
        dev = self.device
        keys = ("depth0", "depth1", "K0", "K1", "q0", "t0", "q1", "t1")
        out = [pair_cell_assignment(
            *(as_device(batch[k][i], dev) for k in keys), grid=self.cfg.grid)
            for i in range(batch["depth0"].shape[0])]
        return torch.stack([g for g, _ in out]), torch.stack(
            [u for _, u in out])

    def loss_and_grads(self, params, batch):
        """The batch's masked mean loss and its gradient over the mesh and
        the group (train/trainer.py::data_parallel_value_and_grad)."""
        n = len(batch["image0"])
        n_pad = pad_to_multiple(n, len(self.mesh.data_devices))
        batch = pad_rows(batch, n_pad)
        gt, uv1 = self.supervise(batch)
        rows = {"im0": as_device(batch["image0"], self.device, torch.float32),
                "im1": as_device(batch["image1"], self.device, torch.float32),
                "gt": gt, "uv1": uv1,
                "live": as_device(live_rows(n, n_pad), self.device)}

        def block_loss(apply, b):
            losses = [self.loss_one(apply, b["im0"][i], b["im1"][i],
                                    b["gt"][i], b["uv1"][i])
                      for i in range(len(b["live"]))]
            return torch.sum(torch.stack(losses) * b["live"])

        return data_parallel_value_and_grad(self.model, params, self.mesh,
                                            rows, block_loss)

    def train_step(self, state: TrainState, batch):
        loss, grads = self.loss_and_grads(state.params, batch)
        g_norm = state.opt_state.step(state.params, grads)
        self.history.append({"loss": float(loss), "grad_norm": g_norm})
        return TrainState(state.params, state.opt_state, state.step + 1), loss

    def save_checkpoint(self, state: TrainState, path: str):
        checkpoint.save_checkpoint(
            path, checkpoint.state_dict_to_flax_variables(state.params),
            step=state.step)

    def load_params(self, path: str, template):
        """Warm-start from a trainer or bootstrap checkpoint: every leaf of
        the template that the file holds is loaded (cast to fp32; a shape
        mismatch raises), leaves it lacks keep their fresh values with JAX's
        warning, and leaves the template lacks are dropped. ASpan and
        MatchFormer checkpoints load strictly (load_arch_params)."""
        if self.cfg.arch not in LOFTR_FAMILY:
            return self._everywhere(checkpoint.load_arch_params(
                path, self.cfg.arch))
        src = checkpoint.read_variables(path)
        missing = []

        def merge(t, s, pathk=""):
            if isinstance(t, dict):
                out = {}
                for k, v in t.items():
                    if isinstance(s, dict) and k in s:
                        out[k] = merge(v, s[k], f"{pathk}/{k}")
                    else:
                        missing.append(f"{pathk}/{k}")
                        out[k] = v
                return out
            if tuple(s.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch at {pathk}: ckpt "
                                 f"{tuple(s.shape)} vs model {tuple(t.shape)}")
            return s

        merged = merge(checkpoint.state_dict_to_flax_variables(template), src)
        if missing:
            print(f"warm-start: {len(missing)} fresh subtrees kept "
                  f"(not in ckpt): {missing[:4]}"
                  f"{'...' if len(missing) > 4 else ''}")
        return self._everywhere(
            checkpoint.flax_variables_to_state_dict(merged))

    def _everywhere(self, state):
        """The leaves on the device, process 0's in every process."""
        params = {k: v.to(self.device) for k, v in state.items()}
        broadcast_from_first(list(params.values()))
        return params


def tuple_to_pair_batch(tuples: list) -> dict:
    """First two views of each trainer tuple -> matcher pair batch."""
    out = {k: [] for k in ("image0", "image1", "depth0", "depth1",
                           "K0", "K1", "q0", "t0", "q1", "t1")}
    for tup in tuples:
        out["image0"].append(tup["images"][0])
        out["image1"].append(tup["images"][1])
        out["depth0"].append(tup["depths"][0])
        out["depth1"].append(tup["depths"][1])
        out["K0"].append(tup["K"][0])
        out["K1"].append(tup["K"][1])
        out["q0"].append(tup["qvec"][0])
        out["t0"].append(tup["tvec"][0])
        out["q1"].append(tup["qvec"][1])
        out["t1"].append(tup["tvec"][1])
    return {k: np.stack(v) for k, v in out.items()}
