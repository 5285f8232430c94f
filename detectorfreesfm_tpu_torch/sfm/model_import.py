"""Empty-model generation / pose-prior import.

Port of the JAX package's sfm/model_import.py (the reference's
generate_empty.py): build a COLMAP model carrying poses + intrinsics
but no 3D points, either from txt dirs ({img}.txt holding a 4x4 matrix,
world-to-camera or camera-to-world) or from a prior COLMAP model directory.
Used by the known-pose triangulation mode and for refinement-only runs on
external reconstructions.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from ..core.geometry import rotmat_to_quat
from ..data import colmap_io
from .reconstruction import Reconstruction, RImage


def _pose_from_matrix(m: np.ndarray, pose_format: str):
    R, t = m[:3, :3], m[:3, 3]
    if pose_format == "c2w":
        R, t = R.T, -R.T @ t
    # float32, as jnp.asarray gives the JAX package's rotmat_to_quat
    return rotmat_to_quat(torch.from_numpy(R.astype(np.float32))).numpy(), t


def load_pose_dir(poses_dir: str, pose_format: str = "w2c") -> Dict[str, tuple]:
    """{stem: (qvec, tvec)} from {img}.txt 4x4 matrices."""
    out = {}
    for f in sorted(os.listdir(poses_dir)):
        if not f.endswith(".txt"):
            continue
        m = np.loadtxt(os.path.join(poses_dir, f)).reshape(4, 4)
        out[os.path.splitext(f)[0]] = _pose_from_matrix(m, pose_format)
    return out


def load_intrin_dir(intrin_dir: str) -> Dict[str, np.ndarray]:
    out = {}
    for f in sorted(os.listdir(intrin_dir)):
        if not f.endswith(".txt"):
            continue
        vals = np.loadtxt(os.path.join(intrin_dir, f))
        out[os.path.splitext(f)[0]] = (
            vals.reshape(3, 3) if vals.size == 9 else vals
        )
    return out


def generate_empty_model(
    image_names: Dict[str, Tuple[int, int]],   # name -> (W, H)
    poses: Dict[str, tuple],                    # name/stem -> (qvec, tvec)
    intrinsics: Optional[Dict[str, np.ndarray]] = None,
    keypoints: Optional[Dict[str, np.ndarray]] = None,
) -> Reconstruction:
    """Reconstruction with registered images, zero points. Pose/intrin keys
    may be full names or stems."""
    def lookup(d, name):
        if d is None:
            return None
        if name in d:
            return d[name]
        stem = os.path.splitext(name)[0]
        return d.get(stem)

    rec = Reconstruction()
    for i, name in enumerate(sorted(image_names), start=1):
        w, h = image_names[name]
        K = lookup(intrinsics, name)
        if K is not None:
            K = np.asarray(K, np.float64)
            params = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
        else:
            f = 1.2 * max(w, h)
            params = np.array([f, f, w / 2.0, h / 2.0])
        rec.add_camera(colmap_io.Camera(i, "PINHOLE", w, h, params))
        kpts = lookup(keypoints, name)
        rec.add_image(RImage(
            id=i, name=name, camera_id=i,
            xys=np.asarray(kpts, np.float64) if kpts is not None
            else np.zeros((0, 2)),
        ))
        pose = lookup(poses, name)
        if pose is not None:
            rec.set_pose(i, np.asarray(pose[0]), np.asarray(pose[1]))
    return rec


def import_from_colmap_prior(model_dir: str) -> Reconstruction:
    """Prior COLMAP model -> Reconstruction with points stripped (the
    reference's import_data_from_colmap_prior path)."""
    cams, images, _points = colmap_io.read_model(model_dir)
    rec = Reconstruction()
    rec.cameras = dict(cams)
    for i, im in images.items():
        rec.images[i] = RImage(
            id=i, name=im.name, camera_id=im.camera_id,
            xys=np.asarray(im.xys, np.float64),
            qvec=np.asarray(im.qvec, np.float64),
            tvec=np.asarray(im.tvec, np.float64),
        )
    return rec
