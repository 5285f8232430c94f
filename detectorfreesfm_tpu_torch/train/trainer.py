"""Multiview-refiner trainer.

Port of the JAX package's train/trainer.py on one device: depth-warp
labels (supervision.generate_tracks) made on the device for each tuple,
the L2-with-std loss on the query views, the gradient with respect to the
whole variables tree, and the optax chain of train/optimizers.py. JAX's
mesh, its padding of the batch to a device multiple and its `live` rows
have no counterpart; the batch mean is the mean over the tuples.

The trainer's state is a `TrainState(params, opt_state, step)` as in JAX:
`params` is the port's state_dict (fp32 tensors on the device, the names
of utils/checkpoint.py) and the model is applied to it with
`torch.func.functional_call`, so `state._replace(params=...)` warm-starts
as JAX's CLI does. Checkpoints are flax msgpack files that JAX's loaders
read (`{"params": variables, "step": n}`).

`load_params` casts a checkpoint to float32, as every other loader of both
packages does. JAX's `Trainer.load_params` alone keeps the stored dtype,
so warm-starting from the bundled bf16 refiner trains bf16 weights there
(ROADMAP, faults of the JAX package).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..device import resolve_device, set_fp32_backends
from ..models.multiview_matcher import MultiviewRefiner, RefinerConfig
from ..utils import checkpoint, prng
from .losses import fine_l2_std_loss
from .optimizers import OptimConfig, Optimizer, build_optimizer
from .supervision import generate_tracks


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    refiner: RefinerConfig = RefinerConfig()
    optim: OptimConfig = OptimConfig()
    n_tracks: int = 200
    grid_step: int = 8
    visibility_tolerance: int = 3
    seed: int = 12345  # reference training seed


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: Optimizer
    step: int


def init_leaves(model: torch.nn.Module, seed: int, device,
                exclude: tuple = ()) -> Dict[str, torch.Tensor]:
    """The model's state_dict, initialised as flax does from a generator
    seeded with `seed`, as fp32 leaves on `device`; names starting with
    one of `exclude` are left out (subtrees flax would not create)."""
    checkpoint.flax_init_(model, torch.Generator().manual_seed(seed))
    model.to(device)
    return {k: v.detach().clone().float() for k, v in
            model.state_dict().items() if not k.startswith(exclude)}


def value_and_grad(model, params: Dict[str, torch.Tensor],
                   loss_fn: Callable):
    """loss_fn(apply) -> scalar, where apply(*args, **kw) runs `model` on
    `params`. Returns (loss, {name: grad}) with respect to every leaf,
    BatchNorm statistics included (see models/backbone.py)."""
    for p in params.values():
        p.requires_grad_(True)

    def apply(*args, **kw):
        return functional_call(model, params, args, kw)

    try:
        loss = loss_fn(apply)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    finally:
        for p in params.values():
            p.requires_grad_(False)
    # A leaf the loss does not reach has a zero gradient, as in JAX.
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(params.items(), grads)}


def as_device(a, dev, dtype=None):
    return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)


class StepLog:
    """Per-step JSON lines to a path (or nowhere): the step's loss, global
    gradient norm (before clipping) and seconds since `t_start` (the
    loss's float() has synchronised the device by then)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            open(path, "w").close()

    def __call__(self, step: int, loss: float, grad_norm: float,
                 t_start: float):
        rec = {"step": step, "loss": loss, "grad_norm": grad_norm,
               "seconds": time.time() - t_start}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


class Trainer:
    """The refiner, its optimizer, the step and checkpoint IO, on `device`
    (None: CUDA; the CPU only when asked). `history` holds each step's
    loss and global gradient norm (before clipping)."""

    def __init__(self, cfg: TrainConfig = TrainConfig(), device=None):
        set_fp32_backends()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = MultiviewRefiner(cfg.refiner)
        self.history = []

    def init_state(self, sample_batch=None) -> TrainState:
        params = init_leaves(self.model, self.cfg.seed, self.device)
        return TrainState(params, build_optimizer(self.cfg.optim, params), 0)

    def loss_one(self, apply, images, spv):
        """Loss of ONE tuple: query views (>= 1) only; the reference view
        is the anchor."""
        out = apply(images, spv.node_img, spv.node_xy, spv.node_scale,
                    spv.node_mask)
        mask = spv.node_mask[:, 1:] & spv.track_valid[:, None]
        return fine_l2_std_loss(out.coords[:, 1:], spv.gt_xy[:, 1:],
                                out.std[:, 1:], mask)

    def supervise(self, batch, rng):
        """Depth-warp labels of each tuple from split(rng, B)."""
        cfg = self.cfg
        dev = self.device
        rngs = prng.split(rng, batch["depths"].shape[0])
        return [generate_tracks(
            as_device(batch["depths"][i], dev), as_device(batch["K"][i], dev),
            as_device(batch["qvec"][i], dev), as_device(batch["tvec"][i], dev),
            rngs[i], grid_step=cfg.grid_step, n_tracks=cfg.n_tracks,
            visibility_tolerance=cfg.visibility_tolerance)
            for i in range(len(rngs))]

    def loss_and_grads(self, params, batch, rng):
        spvs = self.supervise(batch, rng)
        images = as_device(batch["images"], self.device, torch.float32)

        def loss_fn(apply):
            losses = [self.loss_one(apply, images[i], s)
                      for i, s in enumerate(spvs)]
            return torch.stack(losses).mean()

        return value_and_grad(self.model, params, loss_fn)

    def train_step(self, state: TrainState, batch, rng):
        """One step on a batch of tuples; rng is a raw uint32[2] key.
        Returns (new state, loss tensor)."""
        loss, grads = self.loss_and_grads(state.params, batch, rng)
        g_norm = state.opt_state.step(state.params, grads)
        self.history.append({"loss": float(loss), "grad_norm": g_norm})
        return TrainState(state.params, state.opt_state, state.step + 1), loss

    def save_checkpoint(self, state: TrainState, path: str):
        checkpoint.save_checkpoint(
            path, checkpoint.state_dict_to_flax_variables(state.params),
            step=state.step)

    def load_params(self, path: str, template_params):
        """A trainer ({params, step}) or bootstrap ({params}) checkpoint
        with exactly the template's leaves, as fp32 on the device."""
        state = checkpoint.flax_variables_to_state_dict(
            checkpoint.read_variables(path))
        checkpoint.match_state_dict(state, template_params)
        return {k: v.to(self.device) for k, v in state.items()}


def epipolar_pose_eval(coords, gt, mask) -> dict:
    """Mean/median refined-vs-GT pixel error over valid queries."""
    err = np.linalg.norm(np.asarray(coords) - np.asarray(gt), axis=-1)
    live = err[np.asarray(mask)]
    return {
        "mean_px": float(live.mean()) if live.size else float("nan"),
        "median_px": float(np.median(live)) if live.size else float("nan"),
    }
