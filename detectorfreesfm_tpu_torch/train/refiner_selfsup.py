"""Homography self-supervised training of the multiview refiner.

Port of the JAX package's train/refiner_selfsup.py: view 0 is an image of
the folder, views 1..V-1 its random homography warps; track points are
drawn in view 0 and their exact warps are the targets; query inputs are
jittered and the refiner learns to undo the jitter (the L2-with-std loss).
The draws are JAX's from the same seed; the refiner starts from a fresh
flax-style init drawn from a torch.Generator seeded with `seed` (JAX's
draws differ, their distributions do not).

The optimizer is `clip_by_global_norm(0.5)` + `adamw(cosine(lr, steps))`
with optax's default decay of 1e-4 on every leaf. The checkpoint is
`{"params": variables}`, which JAX's `load_refiner_params` reads.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..device import resolve_device, set_fp32_backends
from ..models.multiview_matcher import MultiviewRefiner, RefinerConfig
from ..utils import checkpoint, prng
from .homography import random_homography, warp_image
from .losses import fine_l2_std_loss
from .optimizers import adamw
from .selfsup import load_folder
from .trainer import StepLog, init_leaves, value_and_grad


def selfsup_tracks(key, src, n_views: int, n_tracks: int, margin: int,
                   jitter_px: float):
    """One step's views (V, S, S, 1) and tracks from a source image
    (S, S): node_img, node_xy, node_scale, mask, gt."""
    dev = src.device
    size = src.shape[0]
    v, t = n_views, n_tracks
    kh, kp, kj = key
    Hs = torch.stack([random_homography(k, size, size, device=dev)
                      for k in prng.split(kh, v - 1)])
    views = torch.stack([src] + [warp_image(src, H) for H in Hs])[..., None]
    pts = prng.uniform(kp, (t, 2), margin, size - margin, dev)
    ph = torch.cat([pts, torch.ones((t, 1), device=dev)], -1)
    dst = torch.einsum("vij,tj->vti", Hs, ph)
    z = torch.where(torch.abs(dst[..., 2:]) < 1e-6,
                    torch.full_like(dst[..., 2:], 1e-6), dst[..., 2:])
    q_gt = torch.clamp(dst[..., :2] / z, -4.0 * size, 4.0 * size)
    gt = torch.cat([pts[None], q_gt]).transpose(0, 1)         # (T, V, 2)
    in_frame = ((gt[..., 0] >= margin) & (gt[..., 0] < size - margin)
                & (gt[..., 1] >= margin) & (gt[..., 1] < size - margin))
    in_frame[:, 0] = True
    jit = prng.uniform(kj, (t, v, 2), -jitter_px, jitter_px, dev)
    jit[:, 0] = 0.0
    node_img = torch.arange(v, dtype=torch.int32, device=dev)[None].expand(
        t, v)
    return (views, node_img, gt + jit, torch.ones((t, v), device=dev),
            in_frame, gt)


def train_refiner_selfsup(
    image_dir: str,
    out_path: str,
    steps: int = 1000,
    img_size: int = 256,
    n_views: int = 4,
    n_tracks: int = 128,
    jitter_px: float = 2.0,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 50,
    refiner_cfg: Optional[RefinerConfig] = None,
    init_params=None,
    device=None,
    log_json: Optional[str] = None,
):
    """Returns the trained state_dict (also written to out_path)."""
    dev = resolve_device(device)
    set_fp32_backends()
    imgs = load_folder(image_dir, img_size, dev)
    cfg = refiner_cfg or RefinerConfig()
    model = MultiviewRefiner(cfg)
    params = init_leaves(model, seed, dev)
    if init_params is not None:
        params = {k: init_params[k].to(dev).float().clone() for k in params}
    opt = adamw(params, lr, steps)
    log = StepLog(log_json)
    rng = prng.PRNGKey(seed)
    t0 = time.time()
    for it in range(steps):
        t_step = time.time()
        rng, key = prng.split(rng, 2)
        ki, kh, kp, kj, _kr = prng.split(key, 5)
        src = imgs[int(prng.randint(ki, (), 0, imgs.shape[0], dev))]
        views, node_img, node_xy, node_scale, mask, gt = selfsup_tracks(
            (kh, kp, kj), src, n_views, n_tracks, cfg.crop_size, jitter_px)

        def loss_fn(apply):
            out = apply(views, node_img, node_xy, node_scale, mask)
            return fine_l2_std_loss(out.coords[:, 1:], gt[:, 1:],
                                    out.std[:, 1:], mask[:, 1:])

        loss, grads = value_and_grad(model, params, loss_fn)
        g_norm = opt.step(params, grads)
        rec = log(it, float(loss), g_norm, t_step)
        if (it + 1) % log_every == 0:
            rate = (it + 1) / (time.time() - t0)
            print(f"step {it + 1}/{steps} loss {rec['loss']:.4f} "
                  f"({rate:.2f} it/s)", flush=True)
    checkpoint.save_checkpoint(
        out_path, checkpoint.state_dict_to_flax_variables(params))
    return params


def load_refiner_params(path: str, cfg: Optional[RefinerConfig] = None,
                        img_size: int = 64, n_views: int = 4,
                        n_tracks: int = 8, device=None):
    """The refiner state_dict of a checkpoint that train_refiner_selfsup
    (or the refiner trainer) wrote, on `device` (None: CUDA), at the JAX
    package's name and signature: utils.checkpoint.load_refiner_params.
    `img_size`, `n_views` and `n_tracks` only shaped JAX's template init;
    the port's template needs none."""
    return checkpoint.load_refiner_params(path, cfg, device)
