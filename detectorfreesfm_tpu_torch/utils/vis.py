"""Visualization dumps: the camera-frusta + point-cloud PLY.

Port of `export_reconstruction_ply` from the JAX package's utils/vis.py
(the match plot, `plot_matches`, is not ported yet).
"""

from __future__ import annotations

import numpy as np

from ..data.synthetic import quat_to_rotmat
from ..sfm.reconstruction import Reconstruction


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
