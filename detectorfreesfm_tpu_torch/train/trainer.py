"""Multiview-refiner trainer, data-parallel over a device mesh and over
processes.

Port of the JAX package's train/trainer.py: depth-warp labels
(supervision.generate_tracks) made for each tuple from the step key split
over the padded batch, the L2-with-std loss on the query views, the
gradient with respect to the whole variables tree, and the optax chain of
train/optimizers.py. As in JAX, the batch is padded to a multiple of the
mesh's "data" rows (parallel/mesh.py) with copies of row 0 that `live`
masks out, and the loss is sum(losses * live) / max(sum(live), 1):
`data_parallel_value_and_grad` runs each row block on its device with
that device's copy of the parameters, adds the blocks' loss sums and
gradients on the first device in block order, and, under an initialised
torch.distributed group, sums them over the processes before dividing
(one all_reduce, parallel/orchestrate.py), so every process applies the
same update, clipped by the global norm. `init_state` and `load_params`
start every process from process 0's weights. The group is the caller's,
as JAX's verbs read `jax.process_count()`: nothing here initialises one.

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

from ..device import set_fp32_backends
from ..models.multiview_matcher import MultiviewRefiner, RefinerConfig
from ..parallel.mesh import (mesh_of, pad_to_multiple, replicate,
                             shard_leading_axis)
from ..parallel.orchestrate import all_reduce_sum, broadcast_from_first
from ..utils import checkpoint, prng
from .losses import fine_l2_std_loss
from .optimizers import OptimConfig, Optimizer, build_optimizer
from .supervision import SupervisionBatch, generate_tracks


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


def pad_rows(batch: dict, n_pad: int) -> dict:
    """Each array of the batch padded to n_pad rows with copies of row 0
    (JAX's padding; `live` masks them)."""
    def pad(a):
        a = np.asarray(a)
        if len(a) == n_pad:
            return a
        return np.concatenate([a, np.repeat(a[:1], n_pad - len(a), 0)])
    return {k: pad(v) for k, v in batch.items()}


def live_rows(n: int, n_pad: int) -> np.ndarray:
    return (np.arange(n_pad) < n).astype(np.float32)


def data_parallel_value_and_grad(model, params, mesh, rows, block_loss):
    """JAX's masked batch mean and its gradient, data-parallel.

    rows: a tree of (n_pad, ...) per-row inputs whose "live" leaf is the
    float 0/1 mask, n_pad a multiple of the mesh's "data" rows.
    block_loss(apply, block) -> the sum of live * loss over one block of
    rows (on its device). Block i runs on row i's device with that
    device's copy of `params`; the loss sums and gradients are added on
    the first device in block order, then summed over the processes of an
    initialised torch.distributed group, with the live count, and divided
    by max(live count, 1). Returns (loss, {name: grad}) on the first
    device."""
    first = mesh.first
    sums = []  # every block launched before any is added up
    for p, block in zip(replicate(params, mesh),
                        shard_leading_axis(rows, mesh)):
        sums.append(value_and_grad(model, p,
                                   lambda apply: block_loss(apply, block)))
    loss = sums[0][0].to(first).clone()
    grads = {k: g.to(first).clone() for k, g in sums[0][1].items()}
    for l_i, g_i in sums[1:]:
        loss += l_i.to(first)
        for k, g in g_i.items():
            grads[k] += g.to(first)
    count = rows["live"].sum().to(first, torch.float32).reshape(1)
    names = list(grads)
    all_reduce_sum([loss.reshape(1), count] + [grads[k] for k in names])
    denom = torch.clamp_min(count, 1.0)
    return loss / denom[0], {k: grads[k] / denom[0] for k in names}


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
    """The refiner, its optimizer, the step and checkpoint IO, on `mesh`
    or a one-entry mesh of `device` (neither: the default mesh, which
    needs CUDA; the CPU only when asked). The state lives on the mesh's
    first device. `history` holds each step's loss and global gradient
    norm (before clipping)."""

    def __init__(self, cfg: TrainConfig = TrainConfig(), device=None,
                 mesh=None):
        set_fp32_backends()
        self.cfg = cfg
        self.mesh = mesh_of(device, mesh)
        self.device = self.mesh.first
        self.model = MultiviewRefiner(cfg.refiner)
        self.history = []

    def init_state(self, sample_batch=None) -> TrainState:
        params = init_leaves(self.model, self.cfg.seed, self.device)
        broadcast_from_first(list(params.values()))
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
        """Depth-warp labels of each tuple from split(rng, B), on the
        first device."""
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
        """The batch's masked mean loss and its gradient over the mesh
        (and the group): the batch is padded to the mesh's "data" rows and
        the key split over the padded rows, as JAX splits it."""
        n = len(batch["images"])
        n_pad = pad_to_multiple(n, len(self.mesh.data_devices))
        batch = pad_rows(batch, n_pad)
        spvs = self.supervise(batch, rng)
        rows = {"images": as_device(batch["images"], self.device,
                                    torch.float32),
                "spv": SupervisionBatch(*(torch.stack(f)
                                          for f in zip(*spvs))),
                "live": as_device(live_rows(n, n_pad), self.device)}

        def block_loss(apply, block):
            spv = block["spv"]
            losses = [self.loss_one(apply, block["images"][i],
                                    SupervisionBatch(*(f[i] for f in spv)))
                      for i in range(len(block["live"]))]
            return torch.sum(torch.stack(losses) * block["live"])

        return data_parallel_value_and_grad(self.model, params, self.mesh,
                                            rows, block_loss)

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
        params = {k: v.to(self.device) for k, v in state.items()}
        broadcast_from_first(list(params.values()))
        return params


def epipolar_pose_eval(coords, gt, mask) -> dict:
    """Mean/median refined-vs-GT pixel error over valid queries."""
    err = np.linalg.norm(np.asarray(coords) - np.asarray(gt), axis=-1)
    live = err[np.asarray(mask)]
    return {
        "mean_px": float(live.mean()) if live.size else float("nan"),
        "median_px": float(np.median(live)) if live.size else float("nan"),
    }
