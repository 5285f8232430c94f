"""Posed synthetic scenes rendered on the device from a seed, and feature
tracks taken from their exact geometry.

A torch rewrite of the port's `data/synthetic.py::generate_scene`: seven
textured planes in front of a textured background plane, value-noise
textures of six octaves, cameras around the origin looking at the middle
of the depth range, ray-cast exactly (float64 geometry) at any width and
height, a photometric gain, bias and gamma per view, and 8-bit pixels, as
a PNG on disk would hold them. Scalars (planes, poses) come from a numpy
generator and every bulk draw (textures) from a torch.Generator on the
device, both seeded with the run's seed: the same seed gives the same
scene. Its pixels need not equal the numpy generator's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

OCTAVES = (6, 12, 24, 48, 96, 192)
# generate_scene's defaults: planes, cameras and focal lengths
TEXTURE_SIZE = 768
N_PLANES = 7
DEPTH_RANGE = (4.0, 9.0)
BACKGROUND_DEPTH = 12.0
BACKGROUND_HALF = 30.0
BASELINE = 2.2
FOCAL_RANGE = (0.9, 1.6)        # times the long side
EYE_Z_RANGE = (-1.0, 1.5)
# tracks: the coarse matcher's grid, the matcher's border in pixels, and
# candidate surface points drawn per track wanted
GRID = 4
MARGIN = 16
CANDIDATES = 4


def _seed(seed: int) -> int:
    return int(seed) % (2 ** 63)


@dataclasses.dataclass
class Scene:
    images: torch.Tensor   # (V, H, W) float32 in [0, 1], 8-bit levels
    depths: torch.Tensor   # (V, H, W) float64 camera z of each pixel
    K: np.ndarray          # (V, 3, 3)
    R: np.ndarray          # (V, 3, 3) world -> camera
    t: np.ndarray          # (V, 3)


def _textures(n_tex: int, size: int, gen, device) -> torch.Tensor:
    """(n_tex, size, size) value noise in [0, 1]: each octave a normal
    lattice of (c + 1)^2 values, sampled bilinearly at i * c / size."""
    tex = torch.zeros(n_tex, size, size, device=device)
    amp = 1.0
    for c in OCTAVES:
        g = torch.randn(n_tex, c + 1, c + 1, generator=gen, device=device)
        u = torch.arange(size, device=device, dtype=torch.float32) * c / size
        i0 = u.floor().long()
        w = (u - i0)
        wy, wx = w[:, None], w[None, :]
        a, b = g[:, i0][:, :, i0], g[:, i0][:, :, i0 + 1]
        cc, d = g[:, i0 + 1][:, :, i0], g[:, i0 + 1][:, :, i0 + 1]
        tex += amp * (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx +
                      cc * wy * (1 - wx) + d * wy * wx)
        amp *= 0.55
    lo = tex.amin((1, 2), keepdim=True)
    tex = tex - lo
    return tex / tex.amax((1, 2), keepdim=True).clamp_min(1e-6)


def _planes(rng):
    """[(centre, normal, u axis, v axis)] in float64; the last is the
    background."""
    out = []
    for z in np.linspace(DEPTH_RANGE[0], DEPTH_RANGE[1], N_PLANES):
        c = np.array([rng.uniform(-2.5, 2.5), rng.uniform(-2.0, 2.0), z])
        n = np.array([rng.normal(0, 0.35), rng.normal(0, 0.35), -1.0])
        n /= np.linalg.norm(n)
        u = np.cross(n, [0.0, 1.0, 0.0])
        u /= np.linalg.norm(u)
        v = np.cross(n, u)
        half = rng.uniform(1.0, 2.6)
        out.append((c, n, u * half, v * half * rng.uniform(0.6, 1.2)))
    out.append((np.array([0.0, 0.0, BACKGROUND_DEPTH]),
                np.array([0.0, 0.0, -1.0]),
                np.array([BACKGROUND_HALF, 0.0, 0.0]),
                np.array([0.0, BACKGROUND_HALF, 0.0])))
    return out


def _look_at(eye, target, rng, up_jitter=0.06):
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.array([0.0, -1.0, 0.0]) + rng.normal(0, up_jitter, 3)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def render_scene(seed: int, n_views: int, width: int, height: int,
                 device) -> Scene:
    """`n_views` views of one scene at width x height."""
    rng = np.random.default_rng(_seed(seed))
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed))
    planes = _planes(rng)
    tex = _textures(len(planes), TEXTURE_SIZE, gen, device)
    target = np.array([0.0, 0.0, float(np.mean(DEPTH_RANGE))])
    f64 = dict(dtype=torch.float64, device=device)
    ys, xs = torch.meshgrid(torch.arange(height, **f64) + 0.5,
                            torch.arange(width, **f64) + 0.5, indexing="ij")
    images, depths, Ks, Rs, ts = [], [], [], [], []
    for view in range(n_views):
        eye = np.zeros(3) if view == 0 else np.array([
            rng.uniform(-BASELINE, BASELINE),
            rng.uniform(-BASELINE * 0.6, BASELINE * 0.6),
            rng.uniform(*EYE_Z_RANGE)])
        R = _look_at(eye, target + rng.normal(0, 0.3, 3), rng)
        t = -R @ eye
        f = rng.uniform(*FOCAL_RANGE) * max(width, height)
        K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
        gain, bias, gamma = (rng.uniform(0.7, 1.3), rng.uniform(-0.1, 0.1),
                             rng.uniform(0.7, 1.4))
        d_cam = torch.stack([(xs - K[0, 2]) / f, (ys - K[1, 2]) / f,
                             torch.ones_like(xs)], -1)
        d_world = d_cam @ torch.as_tensor(R, **f64)       # R^T d per ray
        C = torch.as_tensor(-R.T @ t, **f64)
        zbuf = torch.full((height, width), float("inf"), **f64)
        img = torch.zeros(height, width, device=device)
        for k, (p0, n, au, av) in enumerate(planes):
            p0, n, au, av = (torch.as_tensor(a, **f64) for a in (p0, n, au,
                                                                  av))
            denom = d_world @ n
            s = ((p0 - C) @ n) / torch.where(denom.abs() > 1e-9, denom,
                                             torch.ones_like(denom))
            X = C + s[..., None] * d_world
            rel = X - p0
            uu, vv = rel @ au / (au @ au), rel @ av / (av @ av)
            z = X @ torch.as_tensor(R[2], **f64) + t[2]
            ok = (denom.abs() > 1e-9) & (s > 0.1) & (uu.abs() <= 1) & \
                (vv.abs() <= 1) & (z > 0.1) & (z < zbuf)
            T = TEXTURE_SIZE
            tx = ((uu * 0.5 + 0.5) * (T - 1)).float()
            ty = ((vv * 0.5 + 0.5) * (T - 1)).float()
            x0 = tx.floor().long().clamp(0, T - 2)
            y0 = ty.floor().long().clamp(0, T - 2)
            wx, wy = tx - x0, ty - y0
            tk = tex[k]
            val = (tk[y0, x0] * (1 - wy) * (1 - wx) +
                   tk[y0, x0 + 1] * (1 - wy) * wx +
                   tk[y0 + 1, x0] * wy * (1 - wx) +
                   tk[y0 + 1, x0 + 1] * wy * wx)
            img = torch.where(ok, val, img)
            zbuf = torch.where(ok, z, zbuf)
        img = ((img * gain + bias).clamp(0, 1) ** gamma).clamp(0, 1)
        images.append(torch.floor(img * 255.0) / 255.0)
        depths.append(torch.where(torch.isfinite(zbuf), zbuf,
                                  torch.zeros_like(zbuf)))
        Ks.append(K)
        Rs.append(R)
        ts.append(t)
    return Scene(torch.stack(images), torch.stack(depths), np.stack(Ks),
                 np.stack(Rs), np.stack(ts))


def frames(scene: Scene, frame: int) -> torch.Tensor:
    """(V, frame, frame) images zero-padded at the bottom and right, as
    the program's image loader pads them."""
    v, h, w = scene.images.shape
    out = torch.zeros(v, frame, frame, device=scene.images.device)
    out[:, :h, :w] = scene.images
    return out


@dataclasses.dataclass
class Tracks:
    node_img: np.ndarray    # (T, V) int32 view of each node
    node_xy: np.ndarray     # (T, V, 2) float32 (x, y) pixels, 4 px grid
    node_scale: np.ndarray  # (T, V) float32 f/depth over the reference's
    node_mask: np.ndarray   # (T, V) bool
    true_xy: np.ndarray     # (T, V, 2) float32 exact projections


def make_tracks(scene: Scene, seed: int, n_tracks: int, max_len: int
                ) -> Tracks:
    """`n_tracks` tracks of surface points seen by two views or more.

    Candidates are pixels of every view drawn from the seed, lifted to the
    surface by the view's exact depth and projected into every view; a
    node is a view in which the point lies MARGIN px inside the frame and
    is not hidden (its depth within 1% of the view's depth there). Nodes
    sit on the GRID px lattice nearest the projection (the coarse
    matcher's rounding) in pixel-index coordinates; the reference node is
    the view of median scale f/depth, first, the others in view order,
    as the program's track packing orders them."""
    dev = scene.images.device
    v, h, w = scene.images.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(_seed(seed) ^ 0x5EED)
    per_view = -(-CANDIDATES * n_tracks // v)
    f64 = dict(dtype=torch.float64, device=dev)
    Kt = torch.as_tensor(scene.K, **f64)
    Rt = torch.as_tensor(scene.R, **f64)
    tt = torch.as_tensor(scene.t, **f64)
    pts = []
    for k in range(v):
        px = torch.randint(MARGIN, w - MARGIN, (per_view,), generator=gen,
                           device=dev)
        py = torch.randint(MARGIN, h - MARGIN, (per_view,), generator=gen,
                           device=dev)
        z = scene.depths[k, py, px]
        ray = torch.stack([(px + 0.5 - Kt[k, 0, 2]) / Kt[k, 0, 0],
                           (py + 0.5 - Kt[k, 1, 2]) / Kt[k, 1, 1],
                           torch.ones_like(z)], -1)
        cam = ray * z[:, None]
        pts.append((cam - tt[k]) @ Rt[k])            # R^T (cam - t)
    X = torch.cat(pts)
    X = X[torch.randperm(len(X), generator=gen, device=dev)]
    cam = torch.einsum("vij,nj->nvi", Rt, X) + tt    # (N, V, 3)
    z = cam[..., 2]
    uv = torch.einsum("vij,nvj->nvi", Kt, cam)
    u, vv = uv[..., 0] / z, uv[..., 1] / z
    inside = (z > 0.1) & (u >= MARGIN) & (u < w - MARGIN) & \
        (vv >= MARGIN) & (vv < h - MARGIN)
    col = u.clamp(0, w - 1).long()
    row = vv.clamp(0, h - 1).long()
    seen = scene.depths[torch.arange(v, device=dev)[None], row, col]
    vis = inside & ((z - seen).abs() < 0.01 * z)
    keep = vis.sum(1) >= 2
    if int(keep.sum()) < n_tracks:
        raise RuntimeError(f"scene gives {int(keep.sum())} tracks, fewer "
                           f"than {n_tracks}")
    idx = keep.nonzero()[:n_tracks, 0]
    vis, z = vis[idx].cpu().numpy(), z[idx].cpu().numpy()
    xy = torch.stack([u[idx] - 0.5, vv[idx] - 0.5], -1).cpu().numpy()
    f = 0.5 * (scene.K[:, 0, 0] + scene.K[:, 1, 1])
    T = n_tracks
    out = Tracks(np.zeros((T, max_len), np.int32),
                 np.zeros((T, max_len, 2), np.float32),
                 np.ones((T, max_len), np.float32),
                 np.zeros((T, max_len), bool),
                 np.zeros((T, max_len, 2), np.float32))
    for r in range(T):
        views = np.nonzero(vis[r])[0][:max_len]
        scale = f[views] / z[r, views]
        ref = int(np.argsort(scale, kind="stable")[len(scale) // 2])
        order = [ref] + [i for i in range(len(views)) if i != ref]
        vs = views[order]
        n = len(vs)
        out.node_img[r, :n] = vs
        out.true_xy[r, :n] = xy[r, vs]
        out.node_xy[r, :n] = np.round(xy[r, vs] / GRID) * GRID
        out.node_scale[r, :n] = scale[order] / scale[ref]
        out.node_mask[r, :n] = True
    return out


def histogram(tracks: Tracks) -> dict:
    """{track length: count}."""
    lengths, counts = np.unique(tracks.node_mask.sum(1), return_counts=True)
    return {int(k): int(c) for k, c in zip(lengths, counts)}
