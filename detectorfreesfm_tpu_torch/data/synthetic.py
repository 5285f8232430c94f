"""Synthetic posed scenes: textured multi-plane worlds, rendered exactly.

A copy of `SyntheticConfig`, `generate_scene` and their numpy helpers from
the JAX package's data/synthetic.py (pure numpy when no photo textures are
given; PIL is imported only inside the photo-texture helpers), plus the
ground-truth epipolar error the port's checks score matches with, and the
two scene writers (`write_scene`, the trainers' index layout, and
`write_scene_eval_layout`, the CLI's), which write PNG with data/png.py
where JAX uses PIL: the same pixels, depths, index arrays and tuples.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    size: int = 512             # rendered square image size
    n_views: int = 8
    n_planes: int = 7           # textured facets (+1 background plane)
    tuple_size: int = 4         # views per training tuple
    n_tuples: int = 60
    depth_range: Tuple[float, float] = (4.0, 9.0)
    background_depth: float = 12.0
    baseline: float = 2.2       # camera displacement radius
    focal_range: Tuple[float, float] = (0.9, 1.6)  # x image size
    texture_size: int = 768
    photometric: bool = True    # per-view gain/bias/gamma augmentation
    # Real-photo texture pool (paths). When set, most plane textures are
    # random crops of real photographs instead of value noise — the geometry
    # stays exact/synthetic but local appearance matches real-image
    # statistics, which is what the matcher's backbone must transfer to.
    # (Round-2 lesson: noise-textured worlds alone catastrophically shift the
    # feature distribution and destroy real-image matching.)
    texture_photos: Tuple[str, ...] = ()
    photo_texture_prob: float = 0.85
    background_half: float = 30.0  # background-plane half extent (world units)
                                   # — shrink for planar scenes so the texture
                                   # resolution matches the rendered view
    # Viewpoint-difficulty knobs (round-3: the round-2 eval failures were
    # matcher mismatches under harder viewpoint/scale changes — widen the
    # training distribution to cover them).
    up_jitter: float = 0.06        # look-at up-vector jitter (small tilt)
    roll_range: float = 0.0        # extra in-plane camera roll, +-rad
    eye_z_range: Tuple[float, float] = (-1.0, 1.5)  # camera depth spread
                                   # (scale change between views)


def _look_at(eye: np.ndarray, target: np.ndarray, up_jitter: float,
             rng) -> np.ndarray:
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.array([0.0, -1.0, 0.0]) + rng.normal(0, up_jitter, 3)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])  # world->cam rows


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Numpy wxyz quaternion (no jax dependency: generator is host-only)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _multi_octave_texture(rng, n: int) -> np.ndarray:
    """Value-noise texture in [0, 1] with detail at several scales (enough
    gradient structure for 8-px-cell matching)."""
    tex = np.zeros((n, n), np.float32)
    amp = 1.0
    for cells in (6, 12, 24, 48, 96, 192):
        g = rng.normal(0, 1, (cells + 1, cells + 1)).astype(np.float32)
        # bilinear upsample of the lattice
        yy = np.linspace(0, cells, n, endpoint=False)
        xx = np.linspace(0, cells, n, endpoint=False)
        y0 = np.floor(yy).astype(np.int64)
        x0 = np.floor(xx).astype(np.int64)
        wy = (yy - y0)[:, None]
        wx = (xx - x0)[None, :]
        up = (g[y0][:, x0] * (1 - wy) * (1 - wx)
              + g[y0][:, x0 + 1] * (1 - wy) * wx
              + g[y0 + 1][:, x0] * wy * (1 - wx)
              + g[y0 + 1][:, x0 + 1] * wy * wx)
        tex += amp * up
        amp *= 0.55
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return tex


_PHOTO_CACHE: dict = {}


def _load_photo_gray(path: str) -> np.ndarray:
    """Decode a photo to grayscale float [0,1], cached per path."""
    img = _PHOTO_CACHE.get(path)
    if img is None:
        from PIL import Image as PILImage

        img = np.asarray(
            PILImage.open(path).convert("L"), np.float32
        ) / 255.0
        _PHOTO_CACHE[path] = img
    return img


def _photo_texture(rng, n: int, pool: Tuple[str, ...],
                   photo_idx: int | None = None) -> np.ndarray:
    """Random crop of a real photo, resized to (n, n).

    photo_idx pins the source photo: planes of one scene must draw DISTINCT
    photos — two planes cropping the same photo put repeated texture in one
    scene, and the matcher then produces a COHERENT set of cross-plane
    matches that supports a spurious epipolar geometry with more RANSAC
    inliers than the true one (diagnosed round 3: ~half the synth5 eval
    scenes collapsed to 20-40 deg pose error from exactly this)."""
    from PIL import Image as PILImage

    if photo_idx is None:
        photo_idx = int(rng.integers(len(pool)))
    img = _load_photo_gray(pool[photo_idx % len(pool)])
    h, w = img.shape
    side = int(rng.uniform(0.4, 1.0) * min(h, w))
    side = max(side, 64)
    y0 = int(rng.integers(0, max(h - side, 1)))
    x0 = int(rng.integers(0, max(w - side, 1)))
    crop = img[y0 : y0 + side, x0 : x0 + side]
    if rng.random() < 0.5:
        crop = crop[:, ::-1]
    out = np.asarray(PILImage.fromarray(
        (crop * 255).astype(np.uint8)
    ).resize((n, n), PILImage.BILINEAR), np.float32) / 255.0
    # keep contrast healthy (some crops are near-uniform sky/wall)
    rngv = out.max() - out.min()
    if rngv < 0.15:
        out = out + 0.3 * _multi_octave_texture(rng, n)
        out -= out.min()
        out /= max(out.max(), 1e-6)
    return out


def _make_texture(rng, cfg: SyntheticConfig,
                  photo_idx: int | None = None) -> np.ndarray:
    if cfg.texture_photos and rng.random() < cfg.photo_texture_prob:
        return _photo_texture(rng, cfg.texture_size, cfg.texture_photos,
                              photo_idx=photo_idx)
    return _multi_octave_texture(rng, cfg.texture_size)


@dataclasses.dataclass
class _Plane:
    p0: np.ndarray       # center (3,)
    n: np.ndarray        # unit normal (3,) facing the cameras (-z half-space)
    ax_u: np.ndarray     # in-plane axes scaled to half-extents
    ax_v: np.ndarray
    tex: np.ndarray      # (T, T) texture


def _make_world(rng, cfg: SyntheticConfig) -> List[_Plane]:
    planes = []
    zc = np.linspace(cfg.depth_range[0], cfg.depth_range[1], cfg.n_planes)
    # Distinct source photo per plane (incl. background): a without-
    # replacement draw over the pool, so no two surfaces of one scene carry
    # the same texture (see _photo_texture docstring for why this matters).
    n_tex = cfg.n_planes + 1
    if cfg.texture_photos:
        if len(cfg.texture_photos) < n_tex:
            # A pool smaller than n_planes+1 cannot give every surface a
            # distinct photo — indices past the pool would wrap via
            # `% len(pool)` in _photo_texture and silently reintroduce the
            # duplicate-texture degeneracy (advisor r3). Fail loudly.
            raise ValueError(
                f"texture pool has {len(cfg.texture_photos)} photos but "
                f"n_planes+1={n_tex} distinct textures are needed — add "
                f"photos or lower n_planes")
        perm = rng.permutation(len(cfg.texture_photos))[:n_tex]
    else:
        perm = np.zeros(n_tex, np.int64)
    for i in range(cfg.n_planes):
        center = np.array([
            rng.uniform(-2.5, 2.5), rng.uniform(-2.0, 2.0), zc[i]
        ])
        # Normal: roughly facing the cameras with tilt
        n = np.array([rng.normal(0, 0.35), rng.normal(0, 0.35), -1.0])
        n /= np.linalg.norm(n)
        u = np.cross(n, [0.0, 1.0, 0.0])
        u /= np.linalg.norm(u)
        v = np.cross(n, u)
        half = rng.uniform(1.0, 2.6)
        planes.append(_Plane(
            p0=center, n=n, ax_u=u * half, ax_v=v * half * rng.uniform(0.6, 1.2),
            tex=_make_texture(rng, cfg, photo_idx=int(perm[i])),
        ))
    # Background plane (always hit)
    planes.append(_Plane(
        p0=np.array([0.0, 0.0, cfg.background_depth]),
        n=np.array([0.0, 0.0, -1.0]),
        ax_u=np.array([cfg.background_half, 0.0, 0.0]),
        ax_v=np.array([0.0, cfg.background_half, 0.0]),
        tex=_make_texture(rng, cfg, photo_idx=int(perm[-1])),
    ))
    return planes


def _render(planes: List[_Plane], K: np.ndarray, R: np.ndarray,
            t: np.ndarray, size: int):
    """Ray-cast render -> (image (S, S) float [0,1], depth (S, S) float)."""
    C = -R.T @ t
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64) + 0.5
    d_cam = np.stack([
        (xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)
    ], -1).reshape(-1, 3)
    d_world = d_cam @ R  # R^T d per row
    zbuf = np.full(d_world.shape[0], np.inf)
    img = np.zeros(d_world.shape[0], np.float32)
    for pl in planes:
        denom = d_world @ pl.n
        num = (pl.p0 - C) @ pl.n
        with np.errstate(divide="ignore", invalid="ignore"):
            s = num / denom
        hit = (np.abs(denom) > 1e-9) & (s > 0.1)
        X = C[None, :] + s[:, None] * d_world                # (P, 3)
        rel = X - pl.p0
        uu = rel @ pl.ax_u / max(np.dot(pl.ax_u, pl.ax_u), 1e-12)
        vv = rel @ pl.ax_v / max(np.dot(pl.ax_v, pl.ax_v), 1e-12)
        inside = (np.abs(uu) <= 1.0) & (np.abs(vv) <= 1.0)
        # camera z-depth of the hit
        z_cam = (X @ R[2]) + t[2]
        ok = hit & inside & (z_cam > 0.1) & (z_cam < zbuf)
        if not ok.any():
            continue
        T = pl.tex.shape[0]
        tx = (uu[ok] * 0.5 + 0.5) * (T - 1)
        ty = (vv[ok] * 0.5 + 0.5) * (T - 1)
        x0 = np.clip(np.floor(tx).astype(np.int64), 0, T - 2)
        y0 = np.clip(np.floor(ty).astype(np.int64), 0, T - 2)
        wx = (tx - x0).astype(np.float32)
        wy = (ty - y0).astype(np.float32)
        val = (pl.tex[y0, x0] * (1 - wy) * (1 - wx)
               + pl.tex[y0, x0 + 1] * (1 - wy) * wx
               + pl.tex[y0 + 1, x0] * wy * (1 - wx)
               + pl.tex[y0 + 1, x0 + 1] * wy * wx)
        img[ok] = val
        zbuf[ok] = z_cam[ok]
    depth = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
    return img.reshape(size, size), depth.reshape(size, size)


def generate_scene(seed: int, cfg: SyntheticConfig = SyntheticConfig()):
    """Returns (images [V,S,S] f32, depths [V,S,S] f32, K [V,3,3],
    qvec [V,4], tvec [V,3])."""
    rng = np.random.default_rng(seed)
    planes = _make_world(rng, cfg)
    target = np.array([0.0, 0.0, float(np.mean(cfg.depth_range))])
    images, depths, Ks, qs, ts = [], [], [], [], []
    for v in range(cfg.n_views):
        if v == 0:
            eye = np.array([0.0, 0.0, 0.0])
        else:
            eye = np.array([
                rng.uniform(-cfg.baseline, cfg.baseline),
                rng.uniform(-cfg.baseline * 0.6, cfg.baseline * 0.6),
                rng.uniform(*cfg.eye_z_range),
            ])
        R = _look_at(eye, target + rng.normal(0, 0.3, 3), cfg.up_jitter, rng)
        if cfg.roll_range > 0:
            roll = rng.uniform(-cfg.roll_range, cfg.roll_range)
            cr, sr = np.cos(roll), np.sin(roll)
            # in-plane roll about the camera optical axis
            R = np.array([[cr, -sr, 0.0], [sr, cr, 0.0], [0.0, 0.0, 1.0]]) @ R
        t = -R @ eye
        f = rng.uniform(*cfg.focal_range) * cfg.size
        K = np.array([[f, 0, cfg.size / 2], [0, f, cfg.size / 2], [0, 0, 1.0]])
        img, dep = _render(planes, K, R, t, cfg.size)
        if cfg.photometric:
            gain = rng.uniform(0.7, 1.3)
            bias = rng.uniform(-0.1, 0.1)
            gamma = rng.uniform(0.7, 1.4)
            img = np.clip(np.clip(img * gain + bias, 0, 1) ** gamma, 0, 1)
        images.append(img.astype(np.float32))
        depths.append(dep)
        Ks.append(K)
        qs.append(_rotmat_to_quat(R))
        ts.append(t)
    return (np.stack(images), np.stack(depths), np.stack(Ks),
            np.stack(qs), np.stack(ts))


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-15)
    w, x, y, z = np.moveaxis(q, -1, 0)
    r = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def fundamental_matrix(K0, q0, t0, K1, q1, t1) -> np.ndarray:
    """F with x1^T F x0 = 0 for world-to-camera poses (q, t) of two views."""
    R0, R1 = quat_to_rotmat(np.asarray(q0)), quat_to_rotmat(np.asarray(q1))
    R = R1 @ R0.T
    t = np.asarray(t1) - R @ np.asarray(t0)
    tx = np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]],
                   [-t[1], t[0], 0.0]])
    return np.linalg.inv(K1).T @ (tx @ R) @ np.linalg.inv(K0)


def symmetric_epipolar_error(F: np.ndarray, x0: np.ndarray,
                             x1: np.ndarray) -> np.ndarray:
    """(N,) mean of the two point-to-epipolar-line distances, in pixels."""
    p0 = np.concatenate([x0, np.ones((len(x0), 1))], axis=1)
    p1 = np.concatenate([x1, np.ones((len(x1), 1))], axis=1)
    l1 = p0 @ F.T  # epipolar lines in image 1
    l0 = p1 @ F    # epipolar lines in image 0
    num = np.abs(np.sum(p1 * l1, axis=1))
    d1 = num / np.maximum(np.hypot(l1[:, 0], l1[:, 1]), 1e-12)
    d0 = num / np.maximum(np.hypot(l0[:, 0], l0[:, 1]), 1e-12)
    return 0.5 * (d0 + d1)


def _to_u8(img: np.ndarray) -> np.ndarray:
    """The JAX writers' 8-bit pixels: truncation, not rounding."""
    return (img * 255).astype(np.uint8)


def write_scene(out_dir: str, scene_name: str, seed: int,
                cfg: SyntheticConfig = SyntheticConfig()) -> str:
    """Render one scene to disk in the MegaDepth index layout; returns the
    .npz index path. Layout:
      out_dir/scene_name/images/view_###.png
      out_dir/scene_name/depths/view_###.npy
      out_dir/scene_name.npz
    """
    from .png import write_png

    images, depths, K, qvec, tvec = generate_scene(seed, cfg)
    sdir = os.path.join(out_dir, scene_name)
    os.makedirs(os.path.join(sdir, "images"), exist_ok=True)
    os.makedirs(os.path.join(sdir, "depths"), exist_ok=True)
    image_paths, depth_paths = [], []
    for v in range(len(images)):
        ip = os.path.join(scene_name, "images", f"view_{v:03d}.png")
        dp = os.path.join(scene_name, "depths", f"view_{v:03d}.npy")
        write_png(os.path.join(out_dir, ip), _to_u8(images[v]))
        np.save(os.path.join(out_dir, dp), depths[v])
        image_paths.append(ip)
        depth_paths.append(dp)
    rng = np.random.default_rng(seed + 991)
    tuples = np.stack([
        rng.choice(len(images), cfg.tuple_size, replace=False)
        for _ in range(cfg.n_tuples)
    ])
    idx_path = os.path.join(out_dir, f"{scene_name}.npz")
    np.savez(
        idx_path,
        image_paths=np.asarray(image_paths, object),
        depth_paths=np.asarray(depth_paths, object),
        K=K, qvec=qvec, tvec=tvec, tuples=tuples,
    )
    return idx_path


def write_scene_eval_layout(scene_dir: str, seed: int,
                            cfg: SyntheticConfig = SyntheticConfig()):
    """Write one scene in the layout the CLI reads (images/ +
    poses/{stem}.txt 4x4 w2c + intrins/{stem}.txt 3x3), so that the verbs
    score poses against exact ground truth."""
    from .png import write_png

    images, _depths, K, qvec, tvec = generate_scene(seed, cfg)
    for sub in ("images", "poses", "intrins"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    for v in range(len(images)):
        stem = f"view_{v:03d}"
        write_png(os.path.join(scene_dir, "images", stem + ".png"),
                  _to_u8(images[v]))
        a, b, c, d = qvec[v]
        R = np.array([
            [1 - 2 * (c * c + d * d), 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), 1 - 2 * (b * b + d * d), 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), 1 - 2 * (b * b + c * c)],
        ])
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = tvec[v]
        np.savetxt(os.path.join(scene_dir, "poses", stem + ".txt"), M)
        np.savetxt(os.path.join(scene_dir, "intrins", stem + ".txt"), K[v])
