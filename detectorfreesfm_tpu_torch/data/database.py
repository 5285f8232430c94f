"""COLMAP-compatible SQLite database (schema + blob codecs).

Interop-format parity with the reference's src/utils/colmap/database.py:44-417
(cameras / images / keypoints / descriptors / matches / two_view_geometries
tables, the pair_id <-> (image_id1, image_id2) packing, numpy blob codecs,
and the feature/match import surgeries of src/sfm_runner/utils/
make_database.py:7-139). Our engine does not need the DB internally — the
mapper consumes in-memory arrays — but writing one lets COLMAP GUIs and
external tooling inspect our matches, and reading one lets us ingest matches
produced by other front ends.

Port: a copy of the JAX package's data/database.py (sqlite3 and numpy).
"""

from __future__ import annotations

import sqlite3
from typing import Dict, Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
    return image_id1, image_id2


def _blob(a: np.ndarray, dtype) -> bytes:
    return np.ascontiguousarray(a, dtype).tobytes()


def _unblob(b: Optional[bytes], dtype, shape) -> np.ndarray:
    if b is None:
        return np.zeros(shape, dtype)
    return np.frombuffer(b, dtype).reshape(shape).copy()


class COLMAPDatabase:
    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    def close(self):
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- writers --------------------------------------------------------------

    def add_camera(self, model_id: int, width: int, height: int,
                   params: np.ndarray, prior_focal: bool = False,
                   camera_id: Optional[int] = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model_id, int(width), int(height),
             _blob(np.asarray(params), np.float64), int(prior_focal)),
        )
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  image_id: Optional[int] = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id,
             None, None, None, None, None, None, None),
        )
        return cur.lastrowid

    def add_keypoints(self, image_id: int, kpts: np.ndarray,
                      colmap_offset: bool = True):
        """kpts (N, 2) x/y; COLMAP convention stores pixel centers at +0.5
        (reference make_database.py:57 adds the offset on import)."""
        kpts = np.asarray(kpts, np.float32)
        if colmap_offset:
            kpts = kpts + 0.5
        if kpts.shape[1] == 2:  # COLMAP expects >= 4 cols (x, y, scale, ori)
            kpts = np.concatenate(
                [kpts, np.ones((len(kpts), 1), np.float32),
                 np.zeros((len(kpts), 1), np.float32)], 1
            )
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kpts.shape[0], kpts.shape[1], _blob(kpts, np.float32)),
        )

    def add_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        pid = image_ids_to_pair_id(image_id1, image_id2)
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        self.conn.execute(
            "INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
            (pid, m.shape[0], m.shape[1], _blob(m, np.uint32)),
        )

    def add_two_view_geometry(self, image_id1: int, image_id2: int,
                              matches: np.ndarray, F=None, E=None, H=None,
                              config: int = 2):
        pid = image_ids_to_pair_id(image_id1, image_id2)
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        eye = np.eye(3)
        self.conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (pid, m.shape[0], m.shape[1], _blob(m, np.uint32), config,
             _blob(F if F is not None else eye, np.float64),
             _blob(E if E is not None else eye, np.float64),
             _blob(H if H is not None else eye, np.float64),
             _blob(np.array([1.0, 0, 0, 0]), np.float64),
             _blob(np.zeros(3), np.float64)),
        )

    # -- readers --------------------------------------------------------------

    def read_images(self) -> Dict[int, Tuple[str, int]]:
        return {
            i: (name, cam) for i, name, cam in self.conn.execute(
                "SELECT image_id, name, camera_id FROM images"
            )
        }

    def read_keypoints(self) -> Dict[int, np.ndarray]:
        out = {}
        for i, r, c, b in self.conn.execute("SELECT * FROM keypoints"):
            out[i] = _unblob(b, np.float32, (r, c))
        return out

    def read_matches(self) -> Dict[Tuple[int, int], np.ndarray]:
        out = {}
        for pid, r, c, b in self.conn.execute(
            "SELECT pair_id, rows, cols, data FROM matches"
        ):
            out[pair_id_to_image_ids(pid)] = _unblob(b, np.uint32, (r, c))
        return out


def export_scene_to_database(
    path: str,
    keypoints: Dict[str, np.ndarray],
    match_indices: Dict[Tuple[str, str], np.ndarray],
    image_sizes: Dict[str, tuple],
    intrinsics: Optional[Dict[str, np.ndarray]] = None,
    camera_model_id: int = 1,  # PINHOLE
):
    """Write our matching artifacts as a COLMAP database (the role of the
    reference's import_features_and_matches)."""
    with COLMAPDatabase(path) as db:
        name_to_id = {}
        for name in sorted(keypoints):
            w, h = image_sizes[name]
            if intrinsics is not None and name in intrinsics:
                K = intrinsics[name]
                params = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
            else:
                f = 1.2 * max(w, h)
                params = np.array([f, f, w / 2, h / 2])
            cam = db.add_camera(camera_model_id, w, h, params,
                                prior_focal=intrinsics is not None)
            img = db.add_image(name, cam)
            db.add_keypoints(img, keypoints[name])
            name_to_id[name] = img
        for (a, b), m in sorted(match_indices.items()):
            db.add_matches(name_to_id[a], name_to_id[b], m)
