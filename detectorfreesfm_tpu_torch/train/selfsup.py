"""Self-supervised matcher bootstrap: train on a folder of images.

Port of the JAX package's train/selfsup.py: each step draws a batch of
images, warps each by a random homography (train/homography.py), jitters
both views photometrically (gain, bias, noise) and trains the coarse
matcher with the focal loss on the exact cell labels. The draws are JAX's
from the same seed, step by step (`split(rng)` per step, then the step's
own four-way split), so a run sees JAX's batches and warps.

The optimizer is JAX's `clip_by_global_norm(0.5)` + `adamw(cosine(lr,
steps), weight_decay=1e-8)` over the whole variables tree, BatchNorm
statistics included (they decay and get gradients, as in JAX). The
checkpoint is `{"params": variables}`, which JAX's `load_matcher_params`
reads. `log_json` (a path) gets one JSON line per step: its loss, global
gradient norm (before clipping) and seconds. `compute_dtype="bfloat16"`
runs the matcher's forward in bf16 (models/loftr.py); the parameters and
the optimizer stay fp32, as in JAX.

    python -m detectorfreesfm_tpu_torch.cli train-matcher-selfsup \\
        --images <dir> --output ckpt.msgpack --steps 1000
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.images import load_gray
from ..device import resolve_device
from ..models.loftr import DetectorFreeMatcher, MatcherConfig
from ..utils import checkpoint, prng
from .homography import (homography_cell_assignment, random_homography,
                         warp_image)
from .losses import coarse_focal_loss
from .optimizers import adamw
from .trainer import StepLog, init_leaves, value_and_grad


def list_images(image_dir: str):
    names = sorted(f for f in os.listdir(image_dir) if f.lower().endswith(
        (".jpg", ".jpeg", ".png", ".bmp")))
    if not names:
        raise ValueError(f"no images in {image_dir}")
    return names


def load_folder(image_dir: str, img_size: int, device) -> torch.Tensor:
    """Every image of the folder, gray, resized and padded to a square
    of img_size, as (N, S, S) on `device`."""
    return torch.as_tensor(np.stack([
        load_gray(os.path.join(image_dir, n), long_side=img_size,
                  pad_to=img_size).data
        for n in list_images(image_dir)]), device=device)


def photometric(rng, img):
    """Gain exp(U(-0.3, 0.3)), bias U(-0.15, 0.15), noise N(0, 0.02),
    clipped to [0, 1]."""
    k1, k2, k3 = prng.split(rng, 3)
    dev = img.device
    gain = torch.exp(prng.uniform(k1, (), -0.3, 0.3, dev))
    bias = prng.uniform(k2, (), -0.15, 0.15, dev)
    noise = prng.normal(k3, img.shape, dev) * 0.02
    return torch.clamp(img * gain + bias + noise, 0.0, 1.0)


def train_matcher_selfsup(
    image_dir: str,
    out_path: str,
    steps: int = 1000,
    img_size: int = 416,
    batch: int = 4,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 50,
    compute_dtype: str = "float32",
    init_params=None,
    matcher_cfg: Optional[MatcherConfig] = None,
    aug_strength: float = 1.0,
    device=None,
    log_json: Optional[str] = None,
):
    """Returns the trained state_dict (also written to out_path).
    init_params: a state_dict to start from (else a fresh flax-style init
    from `seed`); only the coarse leaves train, as in JAX."""
    dev = resolve_device(device)
    imgs = load_folder(image_dir, img_size, dev)
    cfg = matcher_cfg or MatcherConfig(compute_dtype=compute_dtype)
    model = DetectorFreeMatcher(cfg)  # sets the backends of its dtype
    exclude = () if cfg.fine_enabled else (checkpoint.FINE_PREFIX,)
    params = init_leaves(model, seed, dev, exclude)
    if init_params is not None:
        params = {k: init_params[k].to(dev).float().clone() for k in params}
    opt = adamw(params, lr, steps, weight_decay=1e-8)
    log = StepLog(log_json)
    rng = prng.PRNGKey(seed)
    h = w = img_size
    t0 = time.time()
    for it in range(steps):
        t_step = time.time()
        rng, key = prng.split(rng, 2)
        kb, kh, kp0, kp1 = prng.split(key, 4)
        idx = prng.randint(kb, (batch,), 0, imgs.shape[0], dev).long()
        src = imgs[idx]
        Hs = [random_homography(k, h, w, max_rotation=0.35 * aug_strength,
                                max_scale=0.25 * aug_strength,
                                max_translation=0.15,
                                max_perspective=3e-4 * aug_strength,
                                device=dev)
              for k in prng.split(kh, batch)]
        warped = torch.stack([warp_image(src[i], Hs[i])
                              for i in range(batch)])
        gt = torch.stack([homography_cell_assignment(H, h, w) for H in Hs])
        a = torch.stack([photometric(k, src[i][..., None]) for i, k in
                         enumerate(prng.split(kp0, batch))])
        b = torch.stack([photometric(k, warped[i][..., None]) for i, k in
                         enumerate(prng.split(kp1, batch))])

        def loss_fn(apply):
            _, conf = apply(a, b, return_conf=True)
            return coarse_focal_loss(conf, gt)

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


def load_matcher_params(path: str, img_size: int = 416,
                        cfg: Optional[MatcherConfig] = None):
    """The matcher state_dict of a checkpoint that train_matcher_selfsup
    (or a matcher trainer) wrote, at the JAX package's name and signature:
    utils.checkpoint.load_matcher_params. `img_size` only shaped JAX's
    template init; the port's template needs none."""
    return checkpoint.load_matcher_params(path, cfg)
