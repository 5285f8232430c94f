"""Visualization dumps: match plots and the camera-frusta + point-cloud PLY.

Port of the JAX package's utils/vis.py: a matplotlib match plot where
matplotlib is installed (it is imported at the call; without it,
`plot_matches` raises an ImportError that names the package), and a
camera+points PLY exporter any viewer opens.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.synthetic import quat_to_rotmat
from ..sfm.reconstruction import Reconstruction


def plot_matches(
    image0: np.ndarray, image1: np.ndarray,
    kpts0: np.ndarray, kpts1: np.ndarray,
    conf: Optional[np.ndarray] = None,
    path: Optional[str] = None,
    max_draw: int = 500,
):
    """Side-by-side match plot (grayscale images (H, W)): written to `path`
    as a PNG, or returned as a matplotlib figure."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plot_matches needs matplotlib, which is not installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h = max(image0.shape[0], image1.shape[0])
    w0, w1 = image0.shape[1], image1.shape[1]
    canvas = np.zeros((h, w0 + w1), np.float32)
    canvas[: image0.shape[0], :w0] = image0
    canvas[: image1.shape[0], w0:] = image1
    fig, ax = plt.subplots(figsize=(12, 6))
    ax.imshow(canvas, cmap="gray")
    n = min(len(kpts0), max_draw)
    c = conf[:n] if conf is not None else np.ones(n)
    cmap = plt.get_cmap("turbo")
    for i in range(n):
        color = cmap(float(np.clip(c[i], 0, 1)))
        ax.plot(
            [kpts0[i, 0], kpts1[i, 0] + w0], [kpts0[i, 1], kpts1[i, 1]],
            color=color, linewidth=0.5,
        )
    ax.axis("off")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def export_reconstruction_ply(
    rec: Reconstruction, path: str, frustum_scale: float = 0.2
):
    """Points + camera frusta as one PLY point/edge cloud."""
    verts = []
    colors = []
    for pt in rec.points.values():
        verts.append(pt["xyz"])
        colors.append(pt["rgb"])
    for img_id in rec.registered_images:
        im = rec.images[img_id]
        R = quat_to_rotmat(np.asarray(im.qvec, np.float64))
        C = -R.T @ im.tvec
        verts.append(C)
        colors.append(np.array([255, 0, 0], np.uint8))
        # 4 frustum corner rays
        for dx, dy in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            corner = C + R.T @ (np.array([dx * 0.5, dy * 0.4, 1.0])
                                * frustum_scale)
            verts.append(corner)
            colors.append(np.array([255, 128, 0], np.uint8))
    verts_a = np.asarray(verts, np.float64)
    colors_a = np.asarray(colors, np.uint8)
    with open(path, "wb") as f:
        head = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts_a)}\n"
            "property double x\nproperty double y\nproperty double z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        f.write(head.encode())
        rec_arr = np.empty(
            len(verts_a),
            dtype=[("xyz", "<f8", 3), ("rgb", "u1", 3)],
        )
        rec_arr["xyz"] = verts_a
        rec_arr["rgb"] = colors_a
        f.write(rec_arr.tobytes())
