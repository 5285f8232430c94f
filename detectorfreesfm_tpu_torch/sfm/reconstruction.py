"""In-memory reconstruction: cameras + posed images + 3D points with tracks.

The mapper's working state; convertible to/from the COLMAP bin/txt wire
format (data/colmap_io.py) so the reference's evaluators and standard viewers
keep working. Observation bookkeeping follows COLMAP semantics: every image
holds its full keypoint array `xys` with a parallel `point3D_ids` column
(-1 = no 3D point); every 3D point holds its track as (image_id, point2D_idx)
pairs, and the two views are kept in sync (reference sync contract:
src/dataset/coarse_sfm_refinement_dataset.py:333-341).

Port: a copy of the JAX package's sfm/reconstruction.py (numpy only).
`extract_colors` decodes through data/images.py (no PIL), and unlike the
JAX method it raises when an image that exists fails to decode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.geometry import np_quat_to_rotmat
from ..data import colmap_io


@dataclasses.dataclass
class RImage:
    id: int
    name: str
    camera_id: int
    xys: np.ndarray                     # (K, 2) float64 keypoints (+0.5 px COLMAP convention applied at export)
    qvec: Optional[np.ndarray] = None   # (4,) wxyz world->cam; None = unregistered
    tvec: Optional[np.ndarray] = None
    point3D_ids: np.ndarray = None      # (K,) int64, -1 where no point

    def __post_init__(self):
        if self.point3D_ids is None:
            self.point3D_ids = np.full(len(self.xys), -1, np.int64)

    @property
    def registered(self) -> bool:
        return self.qvec is not None


class Reconstruction:
    def __init__(self):
        self.cameras: Dict[int, colmap_io.Camera] = {}
        self.images: Dict[int, RImage] = {}
        self.points: Dict[int, dict] = {}  # pid -> {xyz, rgb, error, track}
        self._next_pid = 1

    # -- registration / points ------------------------------------------------

    def add_camera(self, cam: colmap_io.Camera):
        self.cameras[cam.id] = cam

    def add_image(self, img: RImage):
        self.images[img.id] = img

    def set_pose(self, image_id: int, qvec: np.ndarray, tvec: np.ndarray):
        im = self.images[image_id]
        im.qvec = np.asarray(qvec, np.float64)
        im.tvec = np.asarray(tvec, np.float64)

    def deregister(self, image_id: int):
        im = self.images[image_id]
        for kpt, pid in enumerate(im.point3D_ids):
            if pid >= 0:
                self.remove_observation(int(pid), image_id, kpt)
        im.qvec = None
        im.tvec = None

    def add_point(
        self,
        xyz: np.ndarray,
        track: List[Tuple[int, int]],
        rgb: np.ndarray | None = None,
        error: float = -1.0,
    ) -> int:
        pid = self._next_pid
        self._next_pid += 1
        kept = []
        for img_id, kpt in track:
            im = self.images[img_id]
            if im.point3D_ids[kpt] >= 0:
                continue  # keypoint already claimed by another point
            im.point3D_ids[kpt] = pid
            kept.append((img_id, kpt))
        if len(kept) < 2:
            for img_id, kpt in kept:
                self.images[img_id].point3D_ids[kpt] = -1
            self._next_pid -= 1
            return -1
        self.points[pid] = {
            "xyz": np.asarray(xyz, np.float64),
            "rgb": np.asarray(rgb if rgb is not None else [128, 128, 128], np.uint8),
            "error": float(error),
            "track": kept,
        }
        return pid

    def remove_observation(self, pid: int, image_id: int, kpt: int):
        pt = self.points.get(pid)
        if pt is None:
            return
        pt["track"] = [(i, k) for (i, k) in pt["track"] if not (i == image_id and k == kpt)]
        self.images[image_id].point3D_ids[kpt] = -1
        if len(pt["track"]) < 2:
            self.remove_point(pid)

    def remove_point(self, pid: int):
        pt = self.points.pop(pid, None)
        if pt is None:
            return
        for img_id, kpt in pt["track"]:
            self.images[img_id].point3D_ids[kpt] = -1

    def merge_points(self, pid_keep: int, pid_drop: int, xyz: np.ndarray):
        """Merge pid_drop's track into pid_keep at position xyz."""
        drop = self.points.pop(pid_drop, None)
        if drop is None:
            return
        keep = self.points[pid_keep]
        for img_id, kpt in drop["track"]:
            im = self.images[img_id]
            if any(i == img_id for i, _ in keep["track"]):
                im.point3D_ids[kpt] = -1  # image already in kept track
            else:
                im.point3D_ids[kpt] = pid_keep
                keep["track"].append((img_id, kpt))
        keep["xyz"] = np.asarray(xyz, np.float64)

    # -- queries ---------------------------------------------------------------

    @property
    def registered_images(self) -> List[int]:
        return [i for i, im in self.images.items() if im.registered]

    def n_observations(self) -> int:
        return sum(len(p["track"]) for p in self.points.values())

    def image_by_name(self, name: str) -> RImage:
        for im in self.images.values():
            if im.name == name:
                return im
        raise KeyError(name)

    def pose_arrays(self, image_ids: List[int]):
        q = np.stack([self.images[i].qvec for i in image_ids])
        t = np.stack([self.images[i].tvec for i in image_ids])
        return q, t

    def K_of_image(self, image_id: int) -> np.ndarray:
        return self.cameras[self.images[image_id].camera_id].K()

    def reprojection_errors(self) -> Dict[int, np.ndarray]:
        """Per-point per-observation pixel reprojection errors (host numpy).

        Fully vectorized: one batched quat->R per unique image and one
        einsum over all observations. The per-observation loop this replaces
        dispatched ~10 eager JAX ops per observation and dominated mapper
        wall time at >=60-camera scale (~60 s of a 176 s run)."""
        pids, counts = [], []
        img_rows, xyz_rows, uv_rows = [], [], []
        img_index: Dict[int, int] = {}
        uniq_ids: List[int] = []
        for pid, pt in self.points.items():
            pids.append(pid)
            counts.append(len(pt["track"]))
            for img_id, kpt in pt["track"]:
                row = img_index.get(img_id)
                if row is None:
                    row = img_index[img_id] = len(uniq_ids)
                    uniq_ids.append(img_id)
                img_rows.append(row)
                xyz_rows.append(pt["xyz"])
                uv_rows.append(self.images[img_id].xys[kpt])
        if not pids:
            return {}
        q = np.stack([self.images[i].qvec for i in uniq_ids])
        t = np.stack([self.images[i].tvec for i in uniq_ids])
        K = np.stack([self.K_of_image(i) for i in uniq_ids])
        k1 = np.asarray([
            self.cameras[self.images[i].camera_id].k1() for i in uniq_ids
        ])
        R = np_quat_to_rotmat(q)                              # (U, 3, 3)
        idx = np.asarray(img_rows, np.int64)
        X = np.asarray(xyz_rows, np.float64)                  # (N, 3)
        uv_obs = np.asarray(uv_rows, np.float64)              # (N, 2)
        Xc = np.einsum("nij,nj->ni", R[idx], X) + t[idx]
        z = np.where(np.abs(Xc[:, 2:]) > 1e-12, Xc[:, 2:], 1e-12)
        xn = (Xc / z)[:, :2]
        # SIMPLE_RADIAL distortion: errors are measured against the raw
        # (distorted) observations, COLMAP semantics
        r2 = np.sum(xn * xn, axis=1, keepdims=True)
        xn = xn * (1.0 + k1[idx][:, None] * r2)
        uv = xn * np.stack([K[idx][:, 0, 0], K[idx][:, 1, 1]], 1) + np.stack(
            [K[idx][:, 0, 2], K[idx][:, 1, 2]], 1)
        errs = np.linalg.norm(uv - uv_obs, axis=1)
        splits = np.split(errs, np.cumsum(counts)[:-1])
        return dict(zip(pids, splits))

    # -- COLMAP interop ----------------------------------------------------------

    def to_colmap(self) -> tuple:
        """Export registered images + points to colmap_io dicts."""
        images = {}
        for i, im in self.images.items():
            if not im.registered:
                continue
            images[i] = colmap_io.Image(
                id=i, qvec=im.qvec.copy(), tvec=im.tvec.copy(),
                camera_id=im.camera_id, name=im.name,
                xys=im.xys.copy(), point3D_ids=im.point3D_ids.copy(),
            )
        points = {}
        for pid, pt in self.points.items():
            points[pid] = colmap_io.Point3D(
                id=pid, xyz=pt["xyz"].copy(), rgb=pt["rgb"].copy(),
                error=pt["error"],
                image_ids=np.asarray([i for i, _ in pt["track"]], np.int32),
                point2D_idxs=np.asarray([k for _, k in pt["track"]], np.int32),
            )
        return dict(self.cameras), images, points

    @classmethod
    def from_colmap(cls, cameras, images, points3D) -> "Reconstruction":
        rec = cls()
        rec.cameras = dict(cameras)
        for i, im in images.items():
            rec.images[i] = RImage(
                id=i, name=im.name, camera_id=im.camera_id,
                xys=np.asarray(im.xys, np.float64),
                qvec=np.asarray(im.qvec, np.float64),
                tvec=np.asarray(im.tvec, np.float64),
                point3D_ids=np.asarray(im.point3D_ids, np.int64).copy(),
            )
        for pid, pt in points3D.items():
            rec.points[pid] = {
                "xyz": np.asarray(pt.xyz, np.float64),
                "rgb": np.asarray(pt.rgb, np.uint8),
                "error": float(pt.error),
                "track": list(zip(pt.image_ids.tolist(), pt.point2D_idxs.tolist())),
            }
        rec._next_pid = max(rec.points, default=0) + 1
        return rec

    def write(self, path: str, ext: str = ".bin"):
        cams, images, points = self.to_colmap()
        colmap_io.write_model(cams, images, points, path, ext)

    def extract_colors(self, image_dir: str) -> int:
        """Fill every 3D point's RGB with the median of the image colors at
        its track's observations (COLMAP `--Mapper.extract_colors`
        equivalent). Host-side: each registered image is decoded once,
        sampled at its claimed keypoints. Returns the number of points
        colored.

        An image missing from image_dir leaves its samples out, as in the
        JAX package; a decode failure raises (the JAX method skips it),
        so that a machine without a decoder cannot write an all-grey
        model without saying so."""
        import os

        from ..data.images import sample_colors

        # pid -> list of (r, g, b) samples across its track
        samples: Dict[int, list] = {}
        for im in self.images.values():
            if not im.registered:
                continue
            claimed = np.nonzero(im.point3D_ids >= 0)[0]
            if len(claimed) == 0:
                continue
            path = os.path.join(image_dir, im.name)
            if not os.path.exists(path):
                continue
            rgb = sample_colors(path, im.xys[claimed])
            for kpt, c in zip(claimed, rgb):
                pid = int(im.point3D_ids[kpt])
                samples.setdefault(pid, []).append(c)
        n = 0
        for pid, cs in samples.items():
            pt = self.points.get(pid)
            if pt is None:
                continue
            pt["rgb"] = np.median(np.stack(cs), axis=0).astype(np.uint8)
            n += 1
        return n
