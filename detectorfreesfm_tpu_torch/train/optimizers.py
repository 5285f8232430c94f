"""Optimizer and learning-rate schedules, as the JAX package's optax ones.

Port of the JAX package's train/optimizers.py. `build_schedule` gives
optax's multistep (piecewise constant), cosine and exponential schedules
with the linear warm-up join, evaluated in float32 as optax evaluates
them. `Optimizer` does what the optax chain does, leaf by leaf:

  clip_by_global_norm(max_norm)   t / ‖g‖ * max_norm when ‖g‖ >= max_norm
                                  (not torch's max_norm / (‖g‖ + 1e-6))
  scale_by_adam()                 b1 0.9, b2 0.999, eps 1e-8, eps_root 0
  add_decayed_weights(wd)         + wd * p (adamw only)
  scale_by_schedule               * -sched(count) * ratio, count before
                                  the update

with `ratio` per leaf: `backbone_lr_ratio` for every leaf whose flax path
holds `backbone_path` (optax.multi_transform's "backbone" label), else 1.
Leaves are named by the port's state_dict names, whose dotted modules are
the flax path. The trainers hand it the same leaves as JAX's whole
variables tree, BatchNorm statistics included (see models/backbone.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adamw"           # "adam" | "adamw"
    canonical_lr: float = 2e-4
    canonical_bs: int = 4
    true_batch_size: int = 4
    weight_decay: float = 0.0
    backbone_lr_ratio: float = 0.5
    backbone_path: str = "backbone"    # param-path part at reduced LR
    scheduler: str = "multistep"       # "multistep" | "cosine" | "exponential"
    milestones: Sequence[int] = (4, 8, 12, 16, 20)  # epochs (MultiStepLR)
    gamma: float = 0.5
    total_steps: int = 100_000         # cosine horizon
    warmup_steps: int = 0
    grad_clip: float = 0.5
    steps_per_epoch: int = 1000

    @property
    def lr(self) -> float:
        return self.canonical_lr * self.true_batch_size / self.canonical_bs


Schedule = Callable[[int], float]


def piecewise_constant_schedule(init: float, boundaries: dict) -> Schedule:
    """optax: from count >= boundary on, the value is scaled."""
    def sched(count):
        v = f32(init)
        for threshold, scale in sorted(boundaries.items()):
            ind = f32(max(0.0, np.sign(threshold - count)))
            v = v * ind + (f32(1) - ind) * f32(scale) * v
        return v
    return sched


def cosine_decay_schedule(init: float, decay_steps: int) -> Schedule:
    def sched(count):
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c
                                             / f32(decay_steps)))
        return f32(init) * cosine
    return sched


def exponential_decay(init: float, transition_steps: int,
                      decay_rate: float) -> Schedule:
    def sched(count):
        if count <= 0:
            return f32(init)
        p = f32(count) / f32(transition_steps)
        return f32(init) * np.power(f32(decay_rate), p)
    return sched


def linear_schedule(init: float, end: float, steps: int) -> Schedule:
    def sched(count):
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return (f32(init) - f32(end)) * frac + f32(end)
    return sched


def join_schedules(schedules, boundaries) -> Schedule:
    def sched(count):
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out
    return sched


def build_schedule(cfg: OptimConfig) -> Schedule:
    if cfg.scheduler == "multistep":
        sched = piecewise_constant_schedule(
            cfg.lr, {int(m * cfg.steps_per_epoch): cfg.gamma
                     for m in cfg.milestones})
    elif cfg.scheduler == "cosine":
        sched = cosine_decay_schedule(cfg.lr, cfg.total_steps)
    elif cfg.scheduler == "exponential":
        sched = exponential_decay(cfg.lr, cfg.steps_per_epoch, cfg.gamma)
    else:
        raise ValueError(cfg.scheduler)
    if cfg.warmup_steps > 0:
        sched = join_schedules(
            [linear_schedule(0.0, cfg.lr, cfg.warmup_steps), sched],
            [cfg.warmup_steps])
    return sched


class Optimizer:
    """optax's clip + Adam(W) + schedule chain over a dict of leaves, with
    its state (the moments and the count) built from `leaves` as
    `tx.init(params)` builds it.

    `step(params, grads)` updates `params` in place (a leaf without a
    gradient counts as a zero gradient, as JAX's would be) and returns the
    global gradient norm before clipping."""

    def __init__(self, leaves: Dict[str, torch.Tensor], sched: Schedule,
                 ratios: Optional[Dict[str, float]] = None,
                 weight_decay: Optional[float] = None, grad_clip: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.sched = sched
        self.ratios = ratios or {k: 1.0 for k in leaves}
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, Optional[torch.Tensor]]) -> float:
        names = list(params)
        p = [params[k] for k in names]
        g = [torch.zeros_like(params[k]) if grads.get(k) is None
             else grads[k] for k in names]
        mu = [self.mu[k] for k in names]
        nu = [self.nu[k] for k in names]
        # One multi-tensor launch per operation over all leaves (a loop
        # over the ~220 leaves of the matcher spent ~100 ms of host time).
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        if self.grad_clip > 0 and bool(g_norm >= self.grad_clip):
            g = torch._foreach_div(g, g_norm)
            torch._foreach_mul_(g, self.grad_clip)
        b1, b2 = self.b1, self.b2
        count_inc = self.count + 1
        c1 = f32(1) - np.power(f32(b1), f32(count_inc))
        c2 = f32(1) - np.power(f32(b2), f32(count_inc))
        lr = f32(self.sched(self.count))
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        u = torch._foreach_div(mu, float(c1))
        den = torch._foreach_div(nu, float(c2))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, [float(-lr * f32(self.ratios[k]))
                                for k in names])
        torch._foreach_add_(p, u)
        self.count = count_inc
        return float(g_norm)


def backbone_ratios(names, cfg: OptimConfig) -> Dict[str, float]:
    """optax.multi_transform's labels: the backbone ratio for every leaf
    whose dotted path holds `backbone_path`, else 1."""
    return {k: cfg.backbone_lr_ratio if any(
        cfg.backbone_path in part for part in k.split(".")) else 1.0
        for k in names}


def build_optimizer(cfg: OptimConfig, leaves: Dict[str, torch.Tensor]
                    ) -> Optimizer:
    """The JAX package's build_optimizer over the same leaves."""
    return Optimizer(
        leaves, build_schedule(cfg), backbone_ratios(leaves, cfg),
        weight_decay=cfg.weight_decay if cfg.optimizer == "adamw" else None,
        grad_clip=cfg.grad_clip)


def adamw(leaves: Dict[str, torch.Tensor], lr: float, steps: int,
          weight_decay: float = 1e-4, grad_clip: float = 0.5) -> Optimizer:
    """`optax.chain(clip_by_global_norm(grad_clip), optax.adamw(
    cosine_decay_schedule(lr, steps), weight_decay=weight_decay))`, the
    self-supervised bootstraps' optimizer (optax's default decay 1e-4)."""
    return Optimizer(leaves, cosine_decay_schedule(lr, steps),
                     weight_decay=weight_decay, grad_clip=grad_clip)
