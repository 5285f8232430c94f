"""COLMAP sparse-model IO (.bin / .txt), kept as the on-disk interop format.

Implements the public COLMAP binary/text format spec from scratch (same wire
format the reference reads/writes via src/utils/colmap/read_write_model.py, so
its evaluators and standard viewers keep working). Unlike the reference's
per-record Python struct loop, reading parses one bytes buffer with a moving
offset and numpy.frombuffer bulk decodes for the fixed-size payloads — fast
enough for 100k-point models on a host CPU.

Port: a copy of the JAX package's data/colmap_io.py (numpy only).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict

import numpy as np

from ..core.geometry import (
    CAMERA_MODEL_IDS,
    CAMERA_MODEL_NAMES,
    CAMERA_MODEL_NUM_PARAMS,
)


@dataclasses.dataclass
class Camera:
    id: int
    model: str  # model name, e.g. "PINHOLE"
    width: int
    height: int
    params: np.ndarray  # float64 (num_params,)

    @property
    def model_id(self) -> int:
        return CAMERA_MODEL_IDS[self.model]

    # Single-focal models: params start [f, cx, cy, ...]
    _SINGLE_F = ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                 "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV")

    def K(self) -> np.ndarray:
        """3x3 intrinsics matrix (ignores distortion params)."""
        p = self.params
        if self.model in self._SINGLE_F:
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)

    def k1(self) -> float:
        """First radial distortion coefficient (0 for distortion-free
        models). SIMPLE_RADIAL params: [f, cx, cy, k] — the reference's
        default ETH3D camera model (hydra_configs/eth3d_sfm/dfsfm.yaml:94)."""
        if self.model in ("SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            return float(self.params[3])
        return 0.0

    def set_k1(self, k: float):
        if self.model not in ("SIMPLE_RADIAL", "RADIAL",
                              "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            raise ValueError(f"{self.model} has no radial k1")
        self.params = self.params.copy()
        self.params[3] = float(k)

    def scale_focal(self, fac: float):
        """Multiply the focal length(s) by fac, model-layout-aware."""
        p = self.params.copy()
        p[0] *= fac
        if self.model not in self._SINGLE_F:
            p[1] *= fac
        self.params = p

    def rescale(self, sx: float, sy: float):
        """Rescale intrinsics for a resolution change by (sx, sy).
        Distortion coefficients act on normalized coords — invariant."""
        p = self.params.copy()
        if self.model in self._SINGLE_F:
            p[0] *= 0.5 * (sx + sy)
            p[1] *= sx
            p[2] *= sy
        else:
            p[0] *= sx
            p[1] *= sy
            p[2] *= sx
            p[3] *= sy
        self.params = p


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray  # (4,) wxyz, world-to-camera
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (N, 2) float64 keypoints
    point3D_ids: np.ndarray  # (N,) int64, -1 if no 3D point


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray  # (3,)
    rgb: np.ndarray  # (3,) uint8
    error: float
    image_ids: np.ndarray  # (T,) int32
    point2D_idxs: np.ndarray  # (T,) int32


# ---------------------------------------------------------------------------
# Binary readers
# ---------------------------------------------------------------------------


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    (n,) = struct.unpack_from("<Q", buf, off); off += 8
    cams: Dict[int, Camera] = {}
    for _ in range(n):
        cam_id, model_id = struct.unpack_from("<ii", buf, off); off += 8
        w, h = struct.unpack_from("<QQ", buf, off); off += 16
        np_ = CAMERA_MODEL_NUM_PARAMS[model_id]
        params = np.frombuffer(buf, dtype="<f8", count=np_, offset=off).copy()
        off += 8 * np_
        cams[cam_id] = Camera(cam_id, CAMERA_MODEL_NAMES[model_id], w, h, params)
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    (n,) = struct.unpack_from("<Q", buf, off); off += 8
    images: Dict[int, Image] = {}
    for _ in range(n):
        (img_id,) = struct.unpack_from("<i", buf, off); off += 4
        qt = np.frombuffer(buf, dtype="<f8", count=7, offset=off).copy(); off += 56
        (cam_id,) = struct.unpack_from("<i", buf, off); off += 4
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode("utf-8"); off = end + 1
        (npts,) = struct.unpack_from("<Q", buf, off); off += 8
        rec = np.frombuffer(buf, dtype="<f8", count=npts * 3, offset=off).reshape(npts, 3)
        off += 24 * npts
        xys = rec[:, :2].copy()
        p3d = rec[:, 2].view("<i8").copy()
        images[img_id] = Image(img_id, qt[:4], qt[4:7], cam_id, name, xys, p3d)
    return images


def read_points3D_binary(path: str) -> Dict[int, Point3D]:
    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    (n,) = struct.unpack_from("<Q", buf, off); off += 8
    pts: Dict[int, Point3D] = {}
    for _ in range(n):
        (pid,) = struct.unpack_from("<q", buf, off); off += 8
        xyz = np.frombuffer(buf, dtype="<f8", count=3, offset=off).copy(); off += 24
        rgb = np.frombuffer(buf, dtype="<u1", count=3, offset=off).copy(); off += 3
        (err,) = struct.unpack_from("<d", buf, off); off += 8
        (tlen,) = struct.unpack_from("<Q", buf, off); off += 8
        track = np.frombuffer(buf, dtype="<i4", count=tlen * 2, offset=off).reshape(tlen, 2)
        off += 8 * tlen
        pts[pid] = Point3D(pid, xyz, rgb, err, track[:, 0].copy(), track[:, 1].copy())
    return pts


# ---------------------------------------------------------------------------
# Binary writers
# ---------------------------------------------------------------------------


def write_cameras_binary(cameras: Dict[int, Camera], path: str) -> None:
    parts = [struct.pack("<Q", len(cameras))]
    for cam in cameras.values():
        parts.append(struct.pack("<iiQQ", cam.id, cam.model_id, cam.width, cam.height))
        parts.append(np.asarray(cam.params, dtype="<f8").tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def write_images_binary(images: Dict[int, Image], path: str) -> None:
    parts = [struct.pack("<Q", len(images))]
    for im in images.values():
        parts.append(struct.pack("<i", im.id))
        parts.append(np.asarray(np.concatenate([im.qvec, im.tvec]), dtype="<f8").tobytes())
        parts.append(struct.pack("<i", im.camera_id))
        parts.append(im.name.encode("utf-8") + b"\x00")
        npts = len(im.xys)
        parts.append(struct.pack("<Q", npts))
        rec = np.empty((npts, 3), dtype="<f8")
        rec[:, :2] = im.xys
        rec[:, 2] = np.asarray(im.point3D_ids, dtype="<i8").view("<f8")
        parts.append(rec.tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def write_points3D_binary(points3D: Dict[int, Point3D], path: str) -> None:
    parts = [struct.pack("<Q", len(points3D))]
    for p in points3D.values():
        parts.append(struct.pack("<q", int(p.id)))
        parts.append(np.asarray(p.xyz, dtype="<f8").tobytes())
        parts.append(np.asarray(p.rgb, dtype="<u1").tobytes())
        parts.append(struct.pack("<d", float(p.error)))
        tlen = len(p.image_ids)
        parts.append(struct.pack("<Q", tlen))
        track = np.empty((tlen, 2), dtype="<i4")
        track[:, 0] = p.image_ids
        track[:, 1] = p.point2D_idxs
        parts.append(track.tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))


# ---------------------------------------------------------------------------
# Text readers / writers
# ---------------------------------------------------------------------------


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams: Dict[int, Camera] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = Camera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array(el[4:], dtype=np.float64),
            )
    return cams


def read_images_text(path: str) -> Dict[int, Image]:
    images: Dict[int, Image] = {}
    with open(path) as f:
        # Keep BLANK lines: an image with zero observations has an empty
        # points2D line (COLMAP writes it), and dropping it would misalign
        # the (pose line, points line) pairing for every later image.
        lines = [l.strip() for l in f if not l.strip().startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        img_id = int(el[0])
        qvec = np.array(el[1:5], dtype=np.float64)
        tvec = np.array(el[5:8], dtype=np.float64)
        cam_id = int(el[8])
        name = el[9]
        el2 = lines[i + 1].split() if i + 1 < len(lines) else []
        if el2:
            rec = np.array(el2, dtype=np.float64).reshape(-1, 3)
            xys = rec[:, :2]
            p3d = rec[:, 2].astype(np.int64)
        else:
            xys = np.zeros((0, 2))
            p3d = np.zeros((0,), dtype=np.int64)
        images[img_id] = Image(img_id, qvec, tvec, cam_id, name, xys, p3d)
    return images


def read_points3D_text(path: str) -> Dict[int, Point3D]:
    pts: Dict[int, Point3D] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            pid = int(el[0])
            xyz = np.array(el[1:4], dtype=np.float64)
            rgb = np.array(el[4:7], dtype=np.uint8)
            err = float(el[7])
            track = np.array(el[8:], dtype=np.int64).reshape(-1, 2)
            pts[pid] = Point3D(
                pid, xyz, rgb, err,
                track[:, 0].astype(np.int32), track[:, 1].astype(np.int32),
            )
    return pts


def write_cameras_text(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(images: Dict[int, Image], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for im in images.values():
            pose = " ".join(repr(float(v)) for v in np.concatenate([im.qvec, im.tvec]))
            f.write(f"{im.id} {pose} {im.camera_id} {im.name}\n")
            obs = " ".join(
                f"{repr(float(x))} {repr(float(y))} {int(pid)}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)
            )
            f.write(obs + "\n")


def write_points3D_text(points3D: Dict[int, Point3D], path: str) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points3D)}\n")
        for p in points3D.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(
                f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs)
            )
            f.write(f"{p.id} {xyz} {rgb} {repr(float(p.error))} {track}\n")


# ---------------------------------------------------------------------------
# Model-level helpers
# ---------------------------------------------------------------------------


def read_model(path: str, ext: str | None = None):
    """Read (cameras, images, points3D) from a model directory."""
    if ext is None:
        ext = ".bin" if os.path.exists(os.path.join(path, "cameras.bin")) else ".txt"
    if ext == ".bin":
        return (
            read_cameras_binary(os.path.join(path, "cameras.bin")),
            read_images_binary(os.path.join(path, "images.bin")),
            read_points3D_binary(os.path.join(path, "points3D.bin")),
        )
    return (
        read_cameras_text(os.path.join(path, "cameras.txt")),
        read_images_text(os.path.join(path, "images.txt")),
        read_points3D_text(os.path.join(path, "points3D.txt")),
    )


def write_model(cameras, images, points3D, path: str, ext: str = ".bin") -> None:
    """Write a model ATOMICALLY: each file goes to a .tmp sibling and is
    os.replace'd into place, so a process killed mid-write (scene-timeout
    SIGKILL, OOM) can never leave a truncated cameras/images/points3D file
    that a resuming run would mistake for a completed stage."""
    os.makedirs(path, exist_ok=True)
    writers = (
        (write_cameras_binary, "cameras.bin"),
        (write_images_binary, "images.bin"),
        (write_points3D_binary, "points3D.bin"),
    ) if ext == ".bin" else (
        (write_cameras_text, "cameras.txt"),
        (write_images_text, "images.txt"),
        (write_points3D_text, "points3D.txt"),
    )
    data = (cameras, images, points3D)
    for (fn, name), d in zip(writers, data):
        tmp = os.path.join(path, name + ".tmp")
        fn(d, tmp)
        os.replace(tmp, os.path.join(path, name))


def write_ply(points3D: Dict[int, Point3D], path: str) -> None:
    """Minimal binary PLY point-cloud export (covers the reference's
    pycolmap export_PLY use at src/evaluator/evaluator.py:270-272)."""
    pts = list(points3D.values())
    n = len(pts)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    ).encode("ascii")
    rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    for i, p in enumerate(pts):
        rec[i] = (p.xyz.astype(np.float32), p.rgb)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rec.tobytes())
