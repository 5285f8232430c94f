"""Incremental mapper: a host loop over batched geometry estimators.

Port of the JAX package's sfm/mapper.py. The irregular control flow
(init-pair choice, next-view selection, registration retries) and the
bookkeeping stay numpy on the host, as there; every numeric estimator
(pair-verification RANSAC, PnP, multi-view DLT triangulation, Schur-LM BA)
runs on the mapper's device. RANSAC draws come from the same content-hash
keys (`utils.prng.stable_rngs`) through `utils.prng.gumbel`, made on that
device, so each call samples as the JAX mapper's does.

Differences from the JAX module:
  * torch has no compiled shapes to keep, so verification runs only the
    real rows of a chunk (JAX pads each chunk to `b_chunk` rows). Rows are
    independent: each has its own key and draws. The point padding
    (`_pad_pow2`) is kept, because the draws' shape (H, n_pad) decides the
    samples.
  * `global_ba(mesh="auto")` shards bundle adjustment over the default
    mesh when it holds more than one card and starts at the mapper's
    device (the JAX module's "more than one device visible"); otherwise
    BA runs on the mapper's device.
  * `times` and `calls` hold each step's wall seconds and call count
    (verify, init, register, triangulate, ba, filter, complete, merge,
    retriangulate). Every step ends by bringing its results to the host,
    so a step's time includes its device work.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.geometry import np_quat_to_rotmat
from ..core.triangulation import triangulate_dlt
from ..data import colmap_io
from ..device import resolve_device
from ..parallel.mesh import canonical_device, get_mesh
from ..utils.prng import gumbel, stable_rngs
from .ba import bundle_adjust
from .reconstruction import Reconstruction, RImage
from .tracks import Track, build_tracks
from .twoview import estimate_relative_pose


def _np(x) -> np.ndarray:
    return x.cpu().numpy()


def _timed(step: str):
    """Add each call's wall seconds to `self.times[step]` and count it in
    `self.calls[step]`."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                self.times[step] = (self.times.get(step, 0.0)
                                    + time.perf_counter() - t0)
                self.calls[step] = self.calls.get(step, 0) + 1
        return timed
    return wrap


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    # Geometric verification / mapper thresholds (px), reference defaults for
    # 8px-grid detector-free keypoints: hydra_configs/eth3d_sfm/dfsfm.yaml:99-111
    geometry_verify_thr: float = 10.0
    init_max_error: float = 10.0
    abs_pose_max_error: float = 12.0
    abs_pose_min_num_inliers: int = 30
    abs_pose_min_inlier_ratio: float = 0.25
    filter_max_reproj_error: float = 10.0
    tri_merge_max_reproj_error: float = 10.0
    tri_complete_max_reproj_error: float = 10.0
    min_tri_angle_deg: float = 1.5
    init_min_tri_angle_deg: float = 4.0
    min_model_size: int = 3
    tri_ignore_two_view_tracks: bool = False
    default_focal_factor: float = 1.2  # COLMAP prior when intrinsics unknown
    # Two-view degeneracy handling (COLMAP TwoViewGeometry model selection):
    # score every verified pair's homography support; pairs with
    # h_inliers/e_inliers above planar_h_ratio are planar/near-pure-rotation,
    # where the 8-point essential solution is unreliable — their seed pose
    # comes from homography decomposition instead.
    compute_homography: bool = True
    planar_h_ratio: float = 0.8
    refine_focal: bool = False         # refine focal in BA (unknown-intrinsics mode)
    # Camera model for NEW cameras (reference default for ETH3D SfM is
    # SIMPLE_RADIAL — hydra_configs/eth3d_sfm/dfsfm.yaml:94). With
    # SIMPLE_RADIAL, k1 starts at 0, geometry runs on iteratively
    # undistorted keypoints, and BA refines k1 (refine_extra_params).
    camera_model: str = "PINHOLE"      # PINHOLE | SIMPLE_RADIAL
    refine_extra_params: bool = True   # refine k1 in BA (SIMPLE_RADIAL only)
    # Unknown-intrinsics focal search: re-run two-view RANSAC at several
    # focal factors and vote a per-image focal from the winning factors
    # (phototourism focals vary several-fold around any single prior; COLMAP
    # leans on EXIF + per-registration focal refinement for the same reason)
    focal_search_factors: tuple = (0.6, 1.0, 1.6)
    ba_global_images_ratio: float = 1.3  # global BA when model grew by this
    max_init_trials: int = 5
    # Init retry (COLMAP init_num_trials): grow the model from up to this
    # many ranked seeds, stopping early once init_retry_target of the images
    # registered; the best-growing attempt wins.
    init_retry_attempts: int = 3
    init_retry_target: float = 0.9
    ransac_hypotheses: int = 512
    seed: int = 0


def _pad_pow2(n: int, lo: int = 64) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


def _camera_cache(rec: Reconstruction) -> Dict[int, tuple]:
    """{img_id: (R, t, C, K)} numpy for all registered images, built with ONE
    batched quat->rotmat call."""
    reg = rec.registered_images
    if not reg:
        return {}
    q = np.stack([rec.images[i].qvec for i in reg])
    R = np_quat_to_rotmat(np.asarray(q, np.float64))
    out = {}
    for k, i in enumerate(reg):
        t = rec.images[i].tvec
        out[i] = (R[k], t, -R[k].T @ t, rec.K_of_image(i))
    return out


class IncrementalMapper:
    """One scene. Usage: mapper = IncrementalMapper(cfg, device);
    rec = mapper.run(...). `device` None means CUDA (and raises without
    it); tests pass "cpu"."""

    def __init__(self, cfg: MapperConfig = MapperConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.times: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def _draws(self, entries, n_hyp: int, n: int):
        """The (len(entries), n_hyp, n) Gumbel draws of the entries'
        content-hash keys (the JAX mapper's `_stable_rngs`): RANSAC
        outcomes do not depend on how calls are batched or ordered."""
        return gumbel(stable_rngs(entries, self.cfg.seed), (n_hyp, n),
                      device=self.device)

    @staticmethod
    def _uxys(rec: Reconstruction, img_id: int) -> np.ndarray:
        """Keypoints of an image, undistorted under the camera's CURRENT k1
        (identity for k1=0 / distortion-free models). All geometric solvers
        (verification, PnP, triangulation, merge/complete/filter) run on
        undistorted coordinates with a pinhole projection; only BA, which
        estimates k1 itself, sees the raw distorted observations.

        Computed fresh per call — im.xys mutates in place during refinement
        and k1 changes after each BA, so caching here would silently go
        stale. The vectorized undistortion is microseconds per image."""
        im = rec.images[img_id]
        cam = rec.cameras[im.camera_id]
        k1 = cam.k1()
        if k1 == 0.0:
            return im.xys
        from ..core.geometry import np_undistort_pixels

        return np_undistort_pixels(im.xys, cam.K(), k1)

    # -- setup -----------------------------------------------------------------

    def _setup(
        self,
        keypoints: Dict[str, np.ndarray],
        image_sizes: Dict[str, Tuple[int, int]],
        intrinsics: Optional[Dict[str, np.ndarray]],
    ) -> Reconstruction:
        rec = Reconstruction()
        self.names = sorted(keypoints)
        self.name_to_id = {n: i + 1 for i, n in enumerate(self.names)}
        self.unknown_K: set = set()   # image ids whose focal is a guess
        for n in self.names:
            i = self.name_to_id[n]
            w, h = image_sizes[n]
            model = self.cfg.camera_model
            if model not in ("PINHOLE", "SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
                # Fail loudly: an unknown model used to fall into the
                # PINHOLE 4-param branch while keeping the label, writing
                # cameras.bin files unreadable by COLMAP and by our own
                # reader (param count keyed by model id).
                raise ValueError(f"unsupported camera model {model!r}")
            if intrinsics is not None and n in intrinsics:
                K = np.asarray(intrinsics[n], np.float64)
                if model == "SIMPLE_RADIAL":
                    f = 0.5 * (K[0, 0] + K[1, 1])
                    params = np.array([f, K[0, 2], K[1, 2], 0.0])
                elif model == "SIMPLE_PINHOLE":
                    f = 0.5 * (K[0, 0] + K[1, 1])
                    params = np.array([f, K[0, 2], K[1, 2]])
                else:
                    params = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
            else:
                f = self.cfg.default_focal_factor * max(w, h)
                if model == "SIMPLE_RADIAL":
                    params = np.array([f, w / 2.0, h / 2.0, 0.0])
                elif model == "SIMPLE_PINHOLE":
                    params = np.array([f, w / 2.0, h / 2.0])
                else:
                    params = np.array([f, f, w / 2.0, h / 2.0])
                self.unknown_K.add(i)
            rec.add_camera(colmap_io.Camera(i, model, w, h, params))
            rec.add_image(
                RImage(id=i, name=n, camera_id=i,
                       xys=np.asarray(keypoints[n], np.float64))
            )
        return rec

    # -- two-view verification ---------------------------------------------------

    def pair_jobs(self, rec: Reconstruction,
                  match_indices: Dict[Tuple[str, str], np.ndarray]) -> list:
        """verify_pairs' jobs, sorted by pair: (na, nb, ia, ib, m, x0, x1,
        f_mean) for every pair of >= 8 matches, with x0, x1 the matches'
        undistorted keypoints in float32 normalized coordinates under the
        cameras' current intrinsics. Host numpy only."""
        jobs = []
        for (na, nb) in sorted(match_indices):
            m = np.asarray(match_indices[(na, nb)])
            if len(m) < 8:
                continue
            ia, ib = self.name_to_id[na], self.name_to_id[nb]
            Ka, Kb = rec.K_of_image(ia), rec.K_of_image(ib)
            uv0 = self._uxys(rec, ia)[m[:, 0]]
            uv1 = self._uxys(rec, ib)[m[:, 1]]
            x0 = np.stack([(uv0[:, 0] - Ka[0, 2]) / Ka[0, 0],
                           (uv0[:, 1] - Ka[1, 2]) / Ka[1, 1]], -1)
            x1 = np.stack([(uv1[:, 0] - Kb[0, 2]) / Kb[0, 0],
                           (uv1[:, 1] - Kb[1, 2]) / Kb[1, 1]], -1)
            f_mean = float(np.mean([Ka[0, 0], Ka[1, 1], Kb[0, 0], Kb[1, 1]]))
            jobs.append((na, nb, ia, ib, m, x0.astype(np.float32),
                         x1.astype(np.float32), f_mean))
        return jobs

    @_timed("verify")
    def verify_pairs(
        self,
        rec: Reconstruction,
        match_indices: Dict[Tuple[str, str], np.ndarray],
        focal_search: bool = False,
    ) -> Dict[Tuple[int, int], dict]:
        """RANSAC-verify every pair; returns {(id0, id1): {matches, qvec,
        tvec, n_inliers}} with only inlier matches kept (the role of hloc's
        geometric verification import).

        With focal_search, each pair is verified at several focal factors and
        the best factor's result is kept; afterwards every camera's focal is
        rescaled to the median winning factor of its pairs (then refined
        further by BA when cfg.refine_focal).

        All (pair x focal-factor) verifications of a size bucket run as
        batched RANSAC calls of up to `b_chunk` real rows each.
        """
        from .twoview import estimate_relative_pose_batch

        cfg = self.cfg
        factors = cfg.focal_search_factors if focal_search else (1.0,)
        nf = len(factors)

        # Jobs: coords normalized once (factor f scales as x / f)
        jobs = self.pair_jobs(rec, match_indices)

        # Bucket jobs by padded match count; each bucket runs in fixed-size
        # chunks so a handful of (n_pad, B_chunk) programs serve any dataset.
        buckets: Dict[int, list] = {}
        for j, job in enumerate(jobs):
            buckets.setdefault(_pad_pow2(len(job[4])), []).append(j)

        results: Dict[int, tuple] = {}  # job idx -> (n_inl, fac, inliers, q, t)
        for n_pad in sorted(buckets):
            idxs = buckets[n_pad]
            # rows = job x factor; chunk to bound the (B, H, N) score tensor
            budget_elems = 1 << 27  # ~0.5 GB fp32 of hypothesis scores
            b_chunk = max(8, min(256, budget_elems // (cfg.ransac_hypotheses * n_pad)))
            b_chunk = 1 << int(np.log2(b_chunk))
            rows = [(j, fi) for j in idxs for fi in range(nf)]
            for start in range(0, len(rows), b_chunk):
                chunk = rows[start : start + b_chunk]
                B = len(chunk)
                x0b = np.zeros((B, n_pad, 2), np.float32)
                x1b = np.zeros((B, n_pad, 2), np.float32)
                maskb = np.zeros((B, n_pad), bool)
                thrb = np.full((B,), 1.0, np.float32)
                for r, (j, fi) in enumerate(chunk):
                    _na, _nb, _ia, _ib, m, x0, x1, f_mean = jobs[j]
                    fac = factors[fi]
                    x0b[r, : len(m)] = x0 / fac
                    x1b[r, : len(m)] = x1 / fac
                    maskb[r, : len(m)] = True
                    thrb[r] = cfg.geometry_verify_thr / (f_mean * fac)
                # Per-pair content-hash keys: verification is invariant to
                # chunk composition
                draws = self._draws(
                    [("verify", jobs[j][0], jobs[j][1], fi)
                     for (j, fi) in chunk], cfg.ransac_hypotheses, n_pad)
                res = estimate_relative_pose_batch(
                    x0b, x1b, maskb, draws, thrb, device=self.device)
                n_inl_b = _np(res.n_inliers)
                inl_b = _np(res.inliers)
                q_b = _np(res.qvec).astype(np.float64)
                t_b = _np(res.tvec).astype(np.float64)
                for r, (j, fi) in enumerate(chunk):
                    prev = results.get(j)
                    if prev is None or int(n_inl_b[r]) > prev[0]:
                        results[j] = (int(n_inl_b[r]), factors[fi],
                                      inl_b[r], q_b[r], t_b[r])

        out: Dict[Tuple[int, int], dict] = {}
        votes: Dict[int, list] = {}
        for j, (_na, _nb, ia, ib, m, _x0, _x1, _f) in enumerate(jobs):
            if j not in results:
                continue
            _n, fac, inliers, qvec, tvec = results[j]
            inl = inliers[: len(m)]
            if inl.sum() < 8:
                continue
            votes.setdefault(ia, []).append(fac)
            votes.setdefault(ib, []).append(fac)
            out[(ia, ib)] = {
                "matches": m[inl],
                "qvec": qvec,
                "tvec": tvec,
                "n_inliers": int(inl.sum()),
            }
        if focal_search:
            for img_id, fs in votes.items():
                fac = float(np.median(fs))
                rec.cameras[rec.images[img_id].camera_id].scale_focal(fac)

        # --- homography degeneracy score (batched, winning factor only) ----
        if cfg.compute_homography and out:
            from .twoview import estimate_homography_batch

            key_of_job = {}
            hbuckets: Dict[int, list] = {}
            for j, (_na, _nb, ia, ib, m, _x0, _x1, _f) in enumerate(jobs):
                if (ia, ib) in out and j in results:
                    key_of_job[j] = (ia, ib)
                    hbuckets.setdefault(_pad_pow2(len(m)), []).append(j)
            n_hyp_h = max(64, cfg.ransac_hypotheses // 2)
            for n_pad in sorted(hbuckets):
                idxs = hbuckets[n_pad]
                budget_elems = 1 << 27
                b_chunk = max(8, min(256, budget_elems // (n_hyp_h * n_pad)))
                b_chunk = 1 << int(np.log2(b_chunk))
                for start in range(0, len(idxs), b_chunk):
                    chunk = idxs[start : start + b_chunk]
                    B = len(chunk)
                    x0b = np.zeros((B, n_pad, 2), np.float32)
                    x1b = np.zeros((B, n_pad, 2), np.float32)
                    maskb = np.zeros((B, n_pad), bool)
                    thrb = np.full((B,), 1.0, np.float32)
                    for r, j in enumerate(chunk):
                        _na, _nb, ia, ib, m, x0, x1, f_mean = jobs[j]
                        fac = results[j][1]
                        x0b[r, : len(m)] = x0 / fac
                        x1b[r, : len(m)] = x1 / fac
                        maskb[r, : len(m)] = True
                        thrb[r] = cfg.geometry_verify_thr / (f_mean * fac)
                    draws = self._draws(
                        [("homog", jobs[j][0], jobs[j][1]) for j in chunk],
                        n_hyp_h, n_pad)
                    resh = estimate_homography_batch(
                        x0b, x1b, maskb, draws, thrb, device=self.device)
                    nh = _np(resh.n_inliers)
                    inl_h = _np(resh.inliers)
                    for r, j in enumerate(chunk):
                        k = key_of_job[j]
                        n_e = out[k]["n_inliers"]
                        out[k]["h_ratio"] = float(nh[r] / max(n_e, 1))
                        # COLMAP TwoViewGeometry semantics: a planar /
                        # pure-rotation pair's inliers come from the
                        # homography, not the degenerate essential model.
                        # The 8-point E on such pairs is chaotic (its
                        # inlier set flips with f32 rounding), while the
                        # H-inlier set is stable and more complete.
                        if (out[k]["h_ratio"] > cfg.planar_h_ratio
                                and int(nh[r]) >= n_e):
                            m = jobs[j][4]
                            out[k]["matches"] = m[inl_h[r, : len(m)]]
                            out[k]["n_inliers"] = int(nh[r])
        return out

    @_timed("init")
    def _twoview_pose(self, rec: Reconstruction, ia: int, ib: int,
                      m: np.ndarray, threshold_px: float,
                      h_ratio: float = 0.0):
        """Relative pose of one pair under the CURRENT camera intrinsics
        (used at init: focal voting rescales per-camera focals after
        verification, so poses stored at a pair's winning search factor can
        disagree with the voted intrinsics — re-estimate before seeding).

        Pairs flagged H-dominant (h_ratio > cfg.planar_h_ratio) get their
        pose from homography decomposition instead — on planar / low-parallax
        geometry the 8-point essential solution is degenerate (COLMAP
        PoseFromHomographyMatrix for PLANAR_OR_PANORAMIC pairs)."""
        from ..core.geometry import rotmat_to_quat as _r2q

        Ka, Kb = rec.K_of_image(ia), rec.K_of_image(ib)
        uv0 = self._uxys(rec, ia)[m[:, 0]]
        uv1 = self._uxys(rec, ib)[m[:, 1]]
        n_pad = _pad_pow2(len(m))
        x0 = np.zeros((n_pad, 2), np.float32)
        x1 = np.zeros((n_pad, 2), np.float32)
        x0[: len(m)] = np.stack([(uv0[:, 0] - Ka[0, 2]) / Ka[0, 0],
                                 (uv0[:, 1] - Ka[1, 2]) / Ka[1, 1]], -1)
        x1[: len(m)] = np.stack([(uv1[:, 0] - Kb[0, 2]) / Kb[0, 0],
                                 (uv1[:, 1] - Kb[1, 2]) / Kb[1, 1]], -1)
        mask = np.zeros(n_pad, bool)
        mask[: len(m)] = True
        f_mean = float(np.mean([Ka[0, 0], Ka[1, 1], Kb[0, 0], Kb[1, 1]]))
        if h_ratio > self.cfg.planar_h_ratio:
            from .twoview import decompose_homography, estimate_homography

            hres = estimate_homography(
                x0, x1, mask,
                self._draws([("init_h", ia, ib, len(m))],
                            self.cfg.ransac_hypotheses, n_pad)[0],
                threshold=threshold_px / f_mean, device=self.device,
            )
            R, t, _n = decompose_homography(
                hres.H, x0, x1, hres.inliers,
                # Full match set: off-plane matches carry the epipolar
                # signal that disambiguates the two plane solutions.
                mask, device=self.device,
            )
            return (_np(_r2q(R)).astype(np.float64),
                    _np(t).astype(np.float64), int(hres.n_inliers))
        res = estimate_relative_pose(
            x0, x1, mask,
            self._draws([("init_e", ia, ib, len(m))],
                        self.cfg.ransac_hypotheses, n_pad)[0],
            threshold=threshold_px / f_mean, device=self.device,
        )
        return (_np(res.qvec).astype(np.float64),
                _np(res.tvec).astype(np.float64), int(res.n_inliers))

    # -- triangulation helpers -----------------------------------------------------

    @_timed("triangulate")
    def _triangulate_tracks(
        self, rec: Reconstruction, tracks: Sequence[Track],
        track_ids: Sequence[int], min_angle_deg: float, max_error: float,
    ) -> Dict[int, Tuple[np.ndarray, List[Tuple[int, int]]]]:
        """Triangulate each candidate track from its currently-registered
        observations; returns {track_id: (xyz, obs_used)} for accepted ones.
        All geometry checks run as vectorized numpy over padded (n, V)
        arrays using a batched camera cache."""
        cache = _camera_cache(rec)
        cand = []
        for tid in track_ids:
            obs = [(i, k) for (i, k) in tracks[tid].observations if i in cache]
            if len(obs) >= 2:
                cand.append((tid, obs))
        if not cand:
            return {}
        V = max(len(o) for _, o in cand)
        n = len(cand)
        n_pad = _pad_pow2(n, lo=32)
        P = np.zeros((n_pad, V, 3, 4), np.float32)
        UV = np.zeros((n_pad, V, 2), np.float32)
        M = np.zeros((n_pad, V), bool)
        R_arr = np.zeros((n, V, 3, 3))
        t_arr = np.zeros((n, V, 3))
        C_arr = np.zeros((n, V, 3))
        K_arr = np.zeros((n, V, 3, 3))
        ux = {}
        for r, (tid, obs) in enumerate(cand):
            for v, (img_id, kpt) in enumerate(obs):
                R, t, C, K = cache[img_id]
                P[r, v, :, :3] = K @ R
                P[r, v, :, 3] = K @ t
                if img_id not in ux:
                    ux[img_id] = self._uxys(rec, img_id)
                UV[r, v] = ux[img_id][kpt]
                M[r, v] = True
                R_arr[r, v], t_arr[r, v], C_arr[r, v], K_arr[r, v] = R, t, C, K
        # --- COLMAP-parity robust triangulation (EstimateTriangulation):
        # hypothesize X from every view PAIR, score by consensus over all
        # observations, then DLT-refit on the best pair's inliers. The
        # union-find track builder fuses every match-connected keypoint, so a
        # single bad match chains two physical points into one track; an
        # all-observation DLT then lands between the clusters and the whole
        # track dies. Pair hypotheses recover the dominant cluster instead.
        live0 = M[:n]
        if V >= 3:
            pairs = [(a, b) for a in range(V) for b in range(a + 1, V)]
            pv = np.array([p[0] for p in pairs])
            pw = np.array([p[1] for p in pairs])
            # rows: for each obs o: [u*P2 - P0; v*P2 - P1]
            rowsA = UV[:n, :, 0:1] * P[:n, :, 2] - P[:n, :, 0]  # (n, V, 4)
            rowsB = UV[:n, :, 1:2] * P[:n, :, 2] - P[:n, :, 1]
            A = np.stack([rowsA[:, pv], rowsB[:, pv],
                          rowsA[:, pw], rowsB[:, pw]], axis=2)  # (n, P2, 4, 4)
            AtA = np.einsum("npij,npik->npjk", A, A)
            _w, vecs = np.linalg.eigh(AtA)
            Xh = vecs[..., :, 0]                                 # (n, P2, 4)
            wc = Xh[..., 3:4]
            wc = np.where(np.abs(wc) < 1e-12, 1e-12, wc)
            Xp = Xh[..., :3] / wc                                # (n, P2, 3)
            pair_valid = live0[:, pv] & live0[:, pw]
            # consensus of each hypothesis over all observations
            Xc_p = (np.einsum("nvij,npj->npvi", R_arr, Xp)
                    + t_arr[:, None, :, :])                      # (n,P2,V,3)
            z_p = Xc_p[..., 2]
            zs = np.where(np.abs(z_p) < 1e-9, 1e-9, z_p)
            uv_p = np.einsum(
                "nvij,npvj->npvi", K_arr, Xc_p / zs[..., None]
            )[..., :2]
            err_p = np.linalg.norm(uv_p - UV[:n, None], axis=-1)
            inl_p = (live0[:, None, :] & (z_p > 1e-6)
                     & (err_p <= max_error) & pair_valid[..., None])
            counts = inl_p.sum(-1)                               # (n, P2)
            best_p = counts.argmax(1)
            rows = np.arange(n)
            g_best = inl_p[rows, best_p]                         # (n, V)
            # DLT refit restricted to the winning consensus (>=2 views)
            M_fit = M.copy()
            M_fit[:n] = g_best & live0
            few = M_fit[:n].sum(1) < 2
            M_fit[:n][few] = live0[few]
        else:
            M_fit = M
        # The view dim is padded to a power-of-two bucket, as in the JAX
        # mapper (padded views are mask-False); the numpy consensus machinery
        # above stays at the true V.
        V_pad = _pad_pow2(V, lo=4)
        P_j, UV_j, M_j = P, UV, M_fit
        if V_pad != V:
            P_j = np.concatenate(
                [P, np.zeros((n_pad, V_pad - V, 3, 4), P.dtype)], axis=1)
            UV_j = np.concatenate(
                [UV, np.zeros((n_pad, V_pad - V, 2), UV.dtype)], axis=1)
            M_j = np.concatenate(
                [M_fit, np.zeros((n_pad, V_pad - V), bool)], axis=1)
        X, ok = triangulate_dlt(P_j, UV_j, M_j, device=self.device)
        X = _np(X).astype(np.float64)[:n]
        ok = _np(ok)[:n] & np.all(np.isfinite(X), axis=1)

        # Vectorized cheirality + reprojection checks over (n, V)
        live = M[:n]
        Xc = np.einsum("nvij,nj->nvi", R_arr, X) + t_arr
        z = Xc[..., 2]
        front = z > 1e-6
        z_safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
        uvp = np.einsum("nvij,nvj->nvi", K_arr, Xc / z_safe[..., None])[..., :2]
        err = np.linalg.norm(uvp - UV[:n], axis=-1)
        good = live & front & (err <= max_error) & ok[:, None]

        # Max pairwise triangulation angle over surviving observations
        rays = C_arr - X[:, None, :]
        rays /= np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
        cosang = np.einsum("nvi,nwi->nvw", rays, rays)
        pair_ok = good[:, :, None] & good[:, None, :]
        np.clip(cosang, -1.0, 1.0, out=cosang)
        ang = np.degrees(np.arccos(cosang))
        ang = np.where(pair_ok, ang, 0.0)
        max_ang = ang.max(axis=(1, 2))

        accepted: Dict[int, Tuple[np.ndarray, list]] = {}
        for r, (tid, obs) in enumerate(cand):
            g = good[r]
            if g.sum() < 2 or max_ang[r] < min_angle_deg:
                continue
            good_obs = [obs[v] for v in range(len(obs)) if g[v]]
            accepted[tid] = (X[r], good_obs)
        return accepted

    # -- registration ----------------------------------------------------------------

    @_timed("register")
    def _try_register(
        self, rec: Reconstruction, img_id: int,
        abs_pose_max_error: Optional[float] = None,
        min_num_inliers: Optional[int] = None,
        min_inlier_ratio: Optional[float] = None,
    ) -> bool:
        """Register one image by PnP-RANSAC over its 2D-3D correspondences.

        Threshold overrides support the reference's relaxed re-registration
        pass (src/sfm_runner/reregistration.py:35-46: a separate
        `reregistration` config with its own abs_pose_* thresholds so images
        dropped during refinement can be recovered)."""
        cfg = self.cfg
        max_err = (cfg.abs_pose_max_error if abs_pose_max_error is None
                   else abs_pose_max_error)
        min_inl = (cfg.abs_pose_min_num_inliers if min_num_inliers is None
                   else min_num_inliers)
        min_ratio = (cfg.abs_pose_min_inlier_ratio if min_inlier_ratio is None
                     else min_inlier_ratio)
        im = rec.images[img_id]
        uxys = self._uxys(rec, img_id)
        X_list, x_list = [], []
        for kpt, tid in self.kpt_track.get(img_id, {}).items():
            pid = self.track_pid[tid]
            if pid >= 0 and pid in rec.points:
                X_list.append(rec.points[pid]["xyz"])
                x_list.append(uxys[kpt])
        n = len(X_list)
        if n < max(6, min_inl):
            return False
        from .pnp import estimate_absolute_pose_batch

        K = rec.K_of_image(img_id)
        f_mean = float((K[0, 0] + K[1, 1]) / 2)
        # Focal search during registration for guessed-focal cameras
        # (COLMAP refines the focal inside absolute-pose estimation for
        # uncalibrated images; the verification-time vote is a coarse prior
        # and phototourism focals vary severalfold around it)
        # Dense grid: the consensus is sharply peaked in focal (observed: an
        # image with 47 inliers at factor 1.2 showed only 4 at 1.0 and 10 at
        # 1.4), so a sparse grid silently loses registrable images. All
        # factors run as ONE batched RANSAC call.
        factors = ((0.4, 0.55, 0.7, 0.85, 1.0, 1.2, 1.45, 1.75, 2.1, 2.6)
                   if (hasattr(self, "unknown_K") and img_id in self.unknown_K)
                   else (1.0,))
        nf = len(factors)
        n_pad = _pad_pow2(n)
        uv = np.asarray(x_list, np.float64)
        x_norm = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0],
                           (uv[:, 1] - K[1, 2]) / K[1, 1]], -1)
        Xp = np.zeros((nf, n_pad, 3), np.float32)
        xp = np.zeros((nf, n_pad, 2), np.float32)
        maskb = np.zeros((nf, n_pad), bool)
        thr = np.empty((nf,), np.float32)
        for fi, fac in enumerate(factors):
            Xp[fi, :n] = np.asarray(X_list)
            xp[fi, :n] = x_norm / fac
            maskb[fi, :n] = True
            thr[fi] = max_err / (f_mean * fac)
        # Content-hash keys: registration outcome depends on the image and
        # its current 2D-3D set, not on how many RANSAC calls preceded it
        # (n varies between retries, so retries resample).
        # Full hypothesis budget: marginal registrations (<=20% inlier
        # ratio at the right focal) are exactly where halving hurts
        draws = self._draws([("register", im.name, n, fi)
                             for fi in range(nf)],
                            max(256, cfg.ransac_hypotheses), n_pad)
        res = estimate_absolute_pose_batch(Xp, xp, maskb, draws, thr,
                                           device=self.device)
        counts = _np(res.n_inliers)
        best = int(np.argmax(counts))
        n_inl = int(counts[best])
        if n_inl < min_inl or n_inl < min_ratio * n:
            return False
        fac = factors[best]
        if fac != 1.0:
            rec.cameras[rec.images[img_id].camera_id].scale_focal(fac)
        rec.set_pose(img_id, _np(res.qvec).astype(np.float64)[best],
                     _np(res.tvec).astype(np.float64)[best])
        return True

    # -- BA + filtering ------------------------------------------------------------

    @_timed("ba")
    def global_ba(self, rec: Reconstruction, fixed_ids: Optional[set] = None,
                  mesh="auto", gauge: str = "similarity"):
        """Global bundle adjustment over the registered model, on the
        mapper's device.

        mesh="auto" shards the observation terms over the default mesh
        (parallel/mesh.py) when it holds more than one card and its first
        is the mapper's device (sharded and single-device solves are
        bit-equal, sfm/ba.py); pass None to force one device, or a mesh.

        gauge: "similarity" (default — fixed_ids are the two init anchors,
        7-DOF gauge, anchor B mostly live) or "full" (every fixed camera's
        pose frozen completely — the known-poses triangulation contract;
        callers with GT poses MUST pass this explicitly)."""
        reg = sorted(rec.registered_images)
        if len(reg) < 2 or not rec.points:
            return
        pids = sorted(rec.points)
        pids_arr = np.asarray(pids, np.int64)
        # Vectorized observation table from the image-side point3D_ids
        # columns. The image-side and
        # point-side views are kept in sync by Reconstruction's bookkeeping,
        # so traversing images yields exactly the track observations.
        uv_parts, cam_parts, pt_parts = [], [], []
        for ci, img_id in enumerate(reg):
            im = rec.images[img_id]
            kpts = np.flatnonzero(im.point3D_ids >= 0)
            if not len(kpts):
                continue
            opids = im.point3D_ids[kpts]
            rows = np.searchsorted(pids_arr, opids)
            ok = (rows < len(pids_arr)) & (
                pids_arr[np.minimum(rows, len(pids_arr) - 1)] == opids
            )
            if not ok.all():  # stale ids would silently corrupt the system
                kpts, rows = kpts[ok], rows[ok]
            uv_parts.append(im.xys[kpts])
            cam_parts.append(np.full(len(kpts), ci, np.int32))
            pt_parts.append(rows.astype(np.int32))
        if not uv_parts:
            return
        obs_uv = np.concatenate(uv_parts)
        obs_cam = np.concatenate(cam_parts)
        obs_pt = np.concatenate(pt_parts)
        q, t = rec.pose_arrays(reg)
        def _cam(i):
            return rec.cameras[rec.images[i].camera_id]
        intr = np.stack([
            np.array([rec.K_of_image(i)[0, 0], rec.K_of_image(i)[1, 1],
                      rec.K_of_image(i)[0, 2], rec.K_of_image(i)[1, 2],
                      _cam(i).k1()])
            for i in reg
        ])
        refine_dist = self.cfg.refine_extra_params and any(
            _cam(i).model == "SIMPLE_RADIAL" for i in reg
        )
        pts = np.stack([rec.points[p]["xyz"] for p in pids])
        if fixed_ids is None:
            # Gauge: fix the first two registered images
            fixed_ids = set(reg[:2])
        fixed = np.array([i in fixed_ids for i in reg])
        if gauge == "similarity" and int(fixed.sum()) != 2:
            # Degenerate anchor set (e.g. coincident camera centers collapsed
            # the farthest pair to one id): fall back to full freeze rather
            # than crash mid-reconstruction.
            print(f"global_ba: similarity gauge needs 2 anchors, got "
                  f"{int(fixed.sum())} -> full freeze", file=sys.stderr)
            gauge = "full"
        if mesh == "auto":
            mesh = None
            if torch.cuda.is_available():
                m = get_mesh()
                if (len(m.data_devices) > 1
                        and m.first == canonical_device(self.device)):
                    mesh = m
        q2, t2, intr2, pts2, _cost = bundle_adjust(
            q, t, intr, pts,
            np.asarray(obs_uv, np.float64),
            obs_cam,
            obs_pt,
            fixed_cams=fixed,
            refine_focal=self.cfg.refine_focal,
            refine_dist=refine_dist,
            huber_delta=4.0,
            gauge=gauge,
            **({"mesh": mesh} if mesh is not None
               else {"device": self.device}),
        )
        for i, img_id in enumerate(reg):
            rec.set_pose(img_id, q2[i], t2[i])
            cam = rec.cameras[rec.images[img_id].camera_id]
            if self.cfg.refine_focal:
                if cam.model == "SIMPLE_RADIAL":
                    f = 0.5 * (intr2[i, 0] + intr2[i, 1])
                    cam.params = np.array([f, intr2[i, 2], intr2[i, 3],
                                           cam.params[3]])
                elif cam.model == "SIMPLE_PINHOLE":
                    f = 0.5 * (intr2[i, 0] + intr2[i, 1])
                    cam.params = np.array([f, intr2[i, 2], intr2[i, 3]])
                else:
                    cam.params = np.array([intr2[i, 0], intr2[i, 1],
                                           intr2[i, 2], intr2[i, 3]])
            if refine_dist and cam.model == "SIMPLE_RADIAL":
                cam.set_k1(float(intr2[i, 4]))
        for j, p in enumerate(pids):
            rec.points[p]["xyz"] = pts2[j]

    @_timed("retriangulate")
    def retriangulate(self, rec: Reconstruction) -> int:
        """Re-solve every point's DLT from its current observations (the
        refiner moves 2D keypoints, so structure must follow before BA —
        COLMAP's incremental_model_refiner retriangulates internally).
        Returns the number of updated points."""
        pids = sorted(rec.points)
        if not pids:
            return 0
        # V padded to a pow2 bucket, as in the JAX mapper; P built from the
        # numpy camera cache.
        V = _pad_pow2(max(len(rec.points[p]["track"]) for p in pids), lo=4)
        n = len(pids)
        n_pad = _pad_pow2(n, lo=32)
        cache = _camera_cache(rec)
        P_of = {i: np.concatenate(
            [K @ R, (K @ t)[:, None]], axis=1).astype(np.float32)
            for i, (R, t, _C, K) in cache.items()}
        Pm = np.zeros((n_pad, V, 3, 4), np.float32)
        UV = np.zeros((n_pad, V, 2), np.float32)
        M = np.zeros((n_pad, V), bool)
        ux = {}
        for r, pid in enumerate(pids):
            v = 0
            for img_id, kpt in rec.points[pid]["track"]:
                if img_id not in P_of or v >= V:  # unregistered obs: skip
                    continue
                Pm[r, v] = P_of[img_id]
                if img_id not in ux:
                    ux[img_id] = self._uxys(rec, img_id)
                UV[r, v] = ux[img_id][kpt]
                M[r, v] = True
                v += 1
        X, ok = triangulate_dlt(Pm, UV, M, device=self.device)
        X = _np(X).astype(np.float64)
        ok = _np(ok)
        n_upd = 0
        for r, pid in enumerate(pids):
            if ok[r] and np.all(np.isfinite(X[r])):
                rec.points[pid]["xyz"] = X[r]
                n_upd += 1
        return n_upd

    @_timed("filter")
    def filter_points(self, rec: Reconstruction, max_error: float,
                      min_angle_deg: float) -> int:
        """Drop observations with reproj error > max_error; drop points whose
        max triangulation angle < min_angle or track < 2. Returns #removed.
        Vectorized over a padded (P, T) observation table."""
        pids = sorted(rec.points)
        if not pids:
            return 0
        cache = _camera_cache(rec)
        T = max(len(rec.points[p]["track"]) for p in pids)
        n = len(pids)
        X = np.stack([rec.points[p]["xyz"] for p in pids])
        R_arr = np.zeros((n, T, 3, 3))
        t_arr = np.zeros((n, T, 3))
        C_arr = np.zeros((n, T, 3))
        K_arr = np.zeros((n, T, 3, 3))
        UV = np.zeros((n, T, 2))
        live = np.zeros((n, T), bool)
        ux = {}
        for r, pid in enumerate(pids):
            for v, (img_id, kpt) in enumerate(rec.points[pid]["track"]):
                if img_id not in cache:
                    continue
                R, t, C, K = cache[img_id]
                R_arr[r, v], t_arr[r, v], C_arr[r, v], K_arr[r, v] = R, t, C, K
                if img_id not in ux:
                    ux[img_id] = self._uxys(rec, img_id)
                UV[r, v] = ux[img_id][kpt]
                live[r, v] = True
        Xc = np.einsum("nvij,nj->nvi", R_arr, X) + t_arr
        z = Xc[..., 2]
        front = z > 1e-6
        z_safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
        uvp = np.einsum("nvij,nvj->nvi", K_arr, Xc / z_safe[..., None])[..., :2]
        err = np.linalg.norm(uvp - UV, axis=-1)
        good = live & front & (err <= max_error)
        rays = C_arr - X[:, None, :]
        rays /= np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
        cosang = np.clip(np.einsum("nvi,nwi->nvw", rays, rays), -1.0, 1.0)
        ang = np.degrees(np.arccos(cosang))
        ang = np.where(good[:, :, None] & good[:, None, :], ang, 0.0)
        max_ang = ang.max(axis=(1, 2))

        removed = 0
        for r, pid in enumerate(pids):
            track = list(rec.points[pid]["track"])
            bad = [track[v] for v in range(len(track)) if live[r, v] and not good[r, v]]
            # also drop observations of unregistered images (live False rows)
            bad += [track[v] for v in range(len(track)) if not live[r, v]]
            for (img_id, kpt) in bad:
                rec.remove_observation(pid, img_id, kpt)
                removed += 1
            if pid in rec.points and max_ang[r] < min_angle_deg:
                rec.remove_point(pid)
                removed += 1
        return removed

    # -- main loop -----------------------------------------------------------------

    def run(
        self,
        keypoints: Dict[str, np.ndarray],
        match_indices: Dict[Tuple[str, str], np.ndarray],
        image_sizes: Dict[str, Tuple[int, int]],
        intrinsics: Optional[Dict[str, np.ndarray]] = None,
        verbose: bool = False,
    ) -> Optional[Reconstruction]:
        cfg = self.cfg
        rec = self._setup(keypoints, image_sizes, intrinsics)
        verified = self.verify_pairs(
            rec, match_indices, focal_search=intrinsics is None
        )
        if not verified:
            return None

        # Track graph over verified matches
        n_kpts = {self.name_to_id[n]: len(keypoints[n]) for n in self.names}
        vm = {pair: v["matches"] for pair, v in verified.items()}
        tracks = build_tracks(n_kpts, vm)
        if cfg.tri_ignore_two_view_tracks:
            tracks = [t for t in tracks if len(t) > 2]
        self.tracks = tracks
        self.track_pid = np.full(len(tracks), -1, np.int64)
        self.kpt_track: Dict[int, Dict[int, int]] = {}
        for tid, t in enumerate(tracks):
            for (img_id, kpt) in t.observations:
                self.kpt_track.setdefault(img_id, {})[kpt] = tid

        # --- initialization ---------------------------------------------------
        # Evaluate the top max_init_trials verified pairs (by inlier count)
        # and COMMIT THE ONE THAT TRIANGULATES THE MOST POINTS — not the
        # first that clears the bar. A high-inlier pair can still be a weak
        # seed (short baseline: most tracks fail the init triangulation-angle
        # check), and a starved init cascades into failed registrations.
        ranked = sorted(verified.items(), key=lambda kv: -kv[1]["n_inliers"])
        init_cands = []  # (n_tri, (ia, ib), tri, qvec, tvec)
        for (ia, ib), v in ranked[: cfg.max_init_trials]:
            qv, tv, _ni = self._twoview_pose(
                rec, ia, ib, v["matches"], cfg.init_max_error,
                h_ratio=v.get("h_ratio", 0.0),
            )
            rec.set_pose(ia, np.array([1.0, 0, 0, 0]), np.zeros(3))
            rec.set_pose(ib, qv, tv)
            tids_a = set(self.kpt_track.get(ia, {}).values())
            tids_b = set(self.kpt_track.get(ib, {}).values())
            tids = sorted(tids_a & tids_b)
            tri = self._triangulate_tracks(
                rec, tracks, tids, cfg.init_min_tri_angle_deg, cfg.init_max_error
            )
            init_cands.append((len(tri), (ia, ib), tri, qv, tv))
            rec.images[ia].qvec = None
            rec.images[ia].tvec = None
            rec.images[ib].qvec = None
            rec.images[ib].tvec = None
        init_cands.sort(key=lambda c: -c[0])
        min_init_pts = 30 if len(ranked) > 1 else 8
        candidates = [c for c in init_cands if c[0] >= min_init_pts]
        if not candidates:
            return None

        # COLMAP-parity init retry (IncrementalMapper init_num_trials): a
        # seed that triangulates well can still fail to grow (near-planar or
        # low-parallax pair — the cloud fits two views but no third). Grow
        # the model from up to init_retry_attempts seeds and keep the best;
        # cameras/points/track state restore between attempts.
        cam_snapshot = {
            cid: cam.params.copy() for cid, cam in rec.cameras.items()
        }
        n_img = len(rec.images)
        max_attempts = min(len(candidates), max(1, cfg.init_retry_attempts))
        best = None  # (n_registered, model snapshot)
        for attempt in range(max_attempts):
            _n, init_pair, tri, qv, tv = candidates[attempt]
            self._grow_from_init(rec, init_pair, tri, qv, tv, verbose=verbose)
            n_reg = len(rec.registered_images)
            if best is None or n_reg > best[0]:
                best = (n_reg, self._model_snapshot(rec))
            if n_reg >= max(3, cfg.init_retry_target * n_img):
                break
            if attempt + 1 < max_attempts:
                if verbose:
                    print(f"init pair {init_pair} grew to only "
                          f"{n_reg}/{n_img} images; retrying with next seed")
                for im in rec.images.values():
                    im.qvec = None
                    im.tvec = None
                    im.point3D_ids[:] = -1
                rec.points = {}
                self.track_pid[:] = -1
                for cid, params in cam_snapshot.items():
                    rec.cameras[cid].params = params.copy()
        if best[0] > len(rec.registered_images):
            self._restore_snapshot(rec, best[1])
            # The restored model was grown in an earlier attempt; images that
            # failed THEN can succeed NOW against its matured geometry (a
            # later attempt may have consumed the remaining retries). One
            # more BA/retriangulate/register fixpoint on the winner.
            reg = rec.registered_images
            if len(reg) >= 2:
                self._registration_fixpoint(rec, set(reg[:2]), verbose)
        if len(rec.registered_images) < cfg.min_model_size:
            return None
        return rec

    def _model_snapshot(self, rec: Reconstruction):
        return (
            {i: (None if im.qvec is None else im.qvec.copy(),
                 None if im.tvec is None else im.tvec.copy(),
                 im.point3D_ids.copy())
             for i, im in rec.images.items()},
            {p: {"xyz": pt["xyz"].copy(), "rgb": pt["rgb"],
                 "error": pt["error"], "track": list(pt["track"])}
             for p, pt in rec.points.items()},
            {cid: cam.params.copy() for cid, cam in rec.cameras.items()},
            self.track_pid.copy(),
        )

    def _restore_snapshot(self, rec: Reconstruction, snap):
        img_s, pts_s, cam_s, tp = snap
        for i, (q, t, pids) in img_s.items():
            im = rec.images[i]
            im.qvec, im.tvec, im.point3D_ids = q, t, pids
        rec.points = pts_s
        for cid, params in cam_s.items():
            rec.cameras[cid].params = params
        self.track_pid = tp

    def _grow_from_init(
        self, rec: Reconstruction, init_pair, tri, qv, tv, verbose=False,
    ) -> Reconstruction:
        """Commit one init pair and grow the model by incremental
        registration + retriangulation + BA/filter fixpoint."""
        cfg = self.cfg
        ia, ib = init_pair
        rec.set_pose(ia, np.array([1.0, 0, 0, 0]), np.zeros(3))
        rec.set_pose(ib, qv, tv)
        for tid, (xyz, obs) in tri.items():
            pid = rec.add_point(xyz, obs)
            if pid >= 0:
                self.track_pid[tid] = pid
        if verbose:
            print(f"init pair ({ia},{ib}): {len(tri)} points")

        self.global_ba(rec, fixed_ids=set(init_pair))
        self.filter_points(rec, cfg.filter_max_reproj_error, cfg.min_tri_angle_deg)

        # --- incremental registration ---
        last_ba_size = 2
        while True:
            unreg = [i for i in rec.images if not rec.images[i].registered]
            if not unreg:
                break
            # Rank by visible 3D correspondences
            scored = []
            for i in unreg:
                cnt = sum(
                    1 for tid in self.kpt_track.get(i, {}).values()
                    if self.track_pid[tid] >= 0 and int(self.track_pid[tid]) in rec.points
                )
                scored.append((cnt, i))
            scored.sort(key=lambda x: (-x[0], x[1]))
            progress = False
            for cnt, img_id in scored:
                if cnt < cfg.abs_pose_min_num_inliers:
                    break
                if self._try_register(rec, img_id):
                    progress = True
                    if verbose:
                        print(f"registered image {img_id} ({cnt} corrs)")
                    # Triangulate ALL pending tracks with >=2 registered
                    # views (COLMAP keeps retriangulating each round — only
                    # doing the new image's tracks starves later
                    # registrations of 2D-3D correspondences)
                    self._triangulate_pending(rec)
                    # Complete existing points with this image's observations
                    self._complete_image(rec, img_id)
                    n_reg = len(rec.registered_images)
                    if n_reg >= last_ba_size * cfg.ba_global_images_ratio:
                        self.global_ba(rec, fixed_ids=set(init_pair))
                        self.filter_points(
                            rec, cfg.filter_max_reproj_error, cfg.min_tri_angle_deg
                        )
                        self._triangulate_pending(rec)
                        last_ba_size = n_reg
                    break
            if not progress:
                break

        self._registration_fixpoint(rec, set(init_pair), verbose)
        return rec

    def _registration_fixpoint(self, rec: Reconstruction, fixed_ids: set,
                               verbose: bool = False):
        # Fixpoint: a global BA + filter cleans the model enough that
        # previously-failed registrations (inlier-ratio rejections against a
        # dirty point set) can succeed — keep alternating until no progress.
        cfg = self.cfg
        for _ in range(len(rec.images)):
            self.global_ba(rec, fixed_ids=fixed_ids)
            self.filter_points(
                rec, cfg.filter_max_reproj_error, cfg.min_tri_angle_deg
            )
            self._triangulate_pending(rec)
            # NOTE: no merge pass here. COLMAP's coarse-mapper merge only
            # considers correspondence-graph-linked point pairs, and our
            # union-find track builder already fuses every match-connected
            # keypoint up front — so at this stage COLMAP-merge is a no-op.
            # Geometric (proximity) merging belongs to the refinement loop
            # where thresholds are tight; with the loose coarse thresholds it
            # collapses real structure (observed: demo registration starved).
            registered_any = False
            for img_id in sorted(rec.images):
                if rec.images[img_id].registered:
                    continue
                cnt = sum(
                    1 for tid in self.kpt_track.get(img_id, {}).values()
                    if self.track_pid[tid] >= 0
                    and int(self.track_pid[tid]) in rec.points
                )
                if cnt < cfg.abs_pose_min_num_inliers:
                    continue
                if self._try_register(rec, img_id):
                    registered_any = True
                    if verbose:
                        print(f"late-registered image {img_id} ({cnt} corrs)")
                    self._triangulate_pending(rec)
                    self._complete_image(rec, img_id)
            if not registered_any:
                break
        # Relaxed second chance (reference reregistration.py:16-46 runs a
        # separate looser-threshold registration config; 20/12 is its
        # abs_pose_max_error ratio). Wrong poses admitted here are caught by
        # the BA + filter of the following fixpoint round or refinement.
        relaxed_any = False
        for img_id in sorted(rec.images):
            if rec.images[img_id].registered:
                continue
            if self._try_register(
                rec, img_id,
                abs_pose_max_error=cfg.abs_pose_max_error * (20.0 / 12.0),
            ):
                relaxed_any = True
                if verbose:
                    print(f"relaxed-registered image {img_id}")
                self._triangulate_pending(rec)
                self._complete_image(rec, img_id)
        if relaxed_any:
            self.global_ba(rec, fixed_ids=fixed_ids)
            self.filter_points(
                rec, cfg.filter_max_reproj_error, cfg.min_tri_angle_deg
            )
        return rec

    def _triangulate_pending(self, rec: Reconstruction):
        """Triangulate every track without a LIVE 3D point that now has >= 2
        registered observations. Tracks whose point was removed by filtering
        count as pending again (COLMAP keeps retriangulating filtered tracks
        each round; a better model after BA can revive them)."""
        cfg = self.cfg
        pending = []
        for tid in range(len(self.tracks)):
            pid = int(self.track_pid[tid])
            if pid < 0:
                pending.append(tid)
            elif pid not in rec.points:
                self.track_pid[tid] = -1
                pending.append(tid)
        if not pending:
            return
        tri = self._triangulate_tracks(
            rec, self.tracks, pending,
            cfg.min_tri_angle_deg, cfg.filter_max_reproj_error,
        )
        for tid, (xyz, obs) in tri.items():
            pid = rec.add_point(xyz, obs)
            if pid >= 0:
                self.track_pid[tid] = pid

    @_timed("complete")
    def _complete_image(self, rec: Reconstruction, img_id: int,
                        max_error: Optional[float] = None,
                        cache: Optional[Dict[int, tuple]] = None,
                        pids_arr: Optional[np.ndarray] = None) -> int:
        """Add this image's observations to already-triangulated tracks when
        they reproject within threshold (COLMAP tri-complete semantics,
        --Mapper.tri_complete_max_reproj_error). Returns #added."""
        cfg = self.cfg
        thr = cfg.tri_complete_max_reproj_error if max_error is None else max_error
        im = rec.images[img_id]
        if cache is None:
            cache = _camera_cache(rec)
        if img_id not in cache:
            return 0
        R, t, _C, K = cache[img_id]
        # Vectorized candidate set: keypoints whose union-find track has a
        # live 3D point but no observation here yet
        d = self.kpt_track.get(img_id, {})
        if not d:
            return 0
        arr = np.full(len(im.xys), -1, np.int64)
        arr[np.fromiter(d.keys(), np.int64, len(d))] = np.fromiter(
            d.values(), np.int64, len(d))
        has_tid = arr >= 0
        pid_of = np.full(len(im.xys), -1, np.int64)
        pid_of[has_tid] = self.track_pid[arr[has_tid]]
        if pids_arr is None:
            pids_arr = np.asarray(sorted(rec.points), np.int64)
        rowk = np.searchsorted(pids_arr, np.maximum(pid_of, 0))
        live = (pid_of >= 0) & (rowk < len(pids_arr)) & (
            pids_arr[np.minimum(rowk, len(pids_arr) - 1)] == pid_of
        )
        kpt_idx = np.flatnonzero(live & (im.point3D_ids < 0))
        if not len(kpt_idx):
            return 0
        cand = [(int(k), int(pid_of[k])) for k in kpt_idx]
        X_by_pid = {p: rec.points[p]["xyz"] for p in
                    np.unique(pid_of[kpt_idx]).tolist()}
        X = np.stack([X_by_pid[pid] for _, pid in cand])
        uv_obs = self._uxys(rec, img_id)[kpt_idx]
        Xc = X @ R.T + t
        z = Xc[:, 2]
        z_safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
        uvp = (Xc / z_safe[:, None]) @ K.T
        err = np.linalg.norm(uvp[:, :2] - uv_obs, axis=-1)
        ok = (z > 1e-6) & (err <= thr)
        n_added = 0
        for (kpt, pid), good in zip(cand, ok):
            if good:
                im.point3D_ids[kpt] = pid
                rec.points[pid]["track"].append((img_id, kpt))
                n_added += 1
        return n_added

    def complete_tracks(self, rec: Reconstruction,
                        max_error: Optional[float] = None) -> int:
        """Tri-complete over every registered image (the per-iteration
        completion pass of COLMAP's incremental_model_refiner verb —
        reference sfm_model_geometry_refiner.py:33-36 sets
        tri_complete_max_reproj_error each refinement iteration)."""
        cache = _camera_cache(rec)
        # completion appends observations but never adds/removes points, so
        # one sorted pid array serves every image
        pids_arr = np.asarray(sorted(rec.points), np.int64)
        return sum(
            self._complete_image(rec, img_id, max_error, cache, pids_arr)
            for img_id in sorted(rec.registered_images)
        )

    @_timed("merge")
    def merge_tracks(self, rec: Reconstruction,
                     max_reproj_error: float) -> int:
        """COLMAP track-merge semantics (--Mapper.tri_merge_max_reproj_error,
        reference sfm_model_geometry_refiner.py:30-33): merge two 3D points
        when the union of their tracks reprojects within threshold at the
        track-length-weighted mean position. Candidates come from 3D
        proximity (kNN at a depth-scaled radius) instead of COLMAP's
        correspondence graph: our union-find track builder already fuses all
        match-connected keypoints, so remaining duplicates are geometric
        (grid-merge near-duplicates, missed matches).

        Fully vectorized: per-round, ALL candidate pairs go
        through batched linkage + union-reprojection gates as numpy array
        programs; only independent accepted pairs merge per round, and
        rounds repeat until a fixpoint (chains a-b-c merge across rounds,
        with the union re-verified against the post-merge state — COLMAP
        re-merges iteratively too). Returns total #merges."""
        total = 0
        for _ in range(8):  # fixpoint cap; real scenes converge in 2-3
            n = self._merge_tracks_round(rec, max_reproj_error)
            total += n
            if n == 0:
                break
        return total

    def _point_table(self, rec: Reconstruction, pids: list):
        """Padded per-point observation table, built vectorized from the
        image-side point3D_ids columns. Returns (uniq_imgs, R_all (U,3,3),
        t_all (U,3), K_all (U,3,3), img_row (P,T), uv (P,T,2), kpt (P,T),
        tid (P,T), mask (P,T))."""
        pids_arr = np.asarray(pids, np.int64)
        reg = sorted(rec.registered_images)
        # Per-image kpt->tid arrays (vectorized lookups; kpt_track itself is
        # a per-build static mapping)
        have_graph = hasattr(self, "kpt_track")
        flat_pid, flat_img, flat_kpt, flat_uv, flat_tid = [], [], [], [], []
        for ui, img_id in enumerate(reg):
            im = rec.images[img_id]
            kpts = np.flatnonzero(im.point3D_ids >= 0)
            if not len(kpts):
                continue
            opids = im.point3D_ids[kpts]
            rows = np.searchsorted(pids_arr, opids)
            ok = (rows < len(pids_arr)) & (
                pids_arr[np.minimum(rows, len(pids_arr) - 1)] == opids
            )
            kpts, rows = kpts[ok], rows[ok]
            flat_pid.append(rows.astype(np.int64))
            flat_img.append(np.full(len(kpts), ui, np.int32))
            flat_kpt.append(kpts.astype(np.int32))
            flat_uv.append(self._uxys(rec, img_id)[kpts])
            if have_graph:
                d = self.kpt_track.get(img_id, {})
                arr = np.full(len(im.xys), -1, np.int64)
                if d:
                    arr[np.fromiter(d.keys(), np.int64, len(d))] = (
                        np.fromiter(d.values(), np.int64, len(d)))
                flat_tid.append(arr[kpts])
            else:
                flat_tid.append(np.full(len(kpts), -1, np.int64))
        if not flat_pid:
            return None
        fp = np.concatenate(flat_pid)
        fi = np.concatenate(flat_img)
        fk = np.concatenate(flat_kpt)
        fuv = np.concatenate(flat_uv)
        ft = np.concatenate(flat_tid)
        # Group by point: stable sort + rank within group
        order = np.argsort(fp, kind="stable")
        fp, fi, fk, fuv, ft = fp[order], fi[order], fk[order], fuv[order], ft[order]
        P = len(pids)
        counts = np.bincount(fp, minlength=P)
        T = max(int(counts.max()), 1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(fp)) - starts[fp]
        img_row = np.zeros((P, T), np.int32)
        uv = np.zeros((P, T, 2), np.float64)
        kpt = np.zeros((P, T), np.int32)
        tid = np.full((P, T), -1, np.int64)
        mask = np.zeros((P, T), bool)
        img_row[fp, rank] = fi
        uv[fp, rank] = fuv
        kpt[fp, rank] = fk
        tid[fp, rank] = ft
        mask[fp, rank] = True

        q = np.stack([rec.images[i].qvec for i in reg])
        R_all = np_quat_to_rotmat(np.asarray(q, np.float64))
        t_all = np.stack([rec.images[i].tvec for i in reg])
        K_all = np.stack([rec.K_of_image(i) for i in reg])
        return reg, R_all, t_all, K_all, img_row, uv, kpt, tid, mask

    def _merge_tracks_round(self, rec: Reconstruction,
                            max_reproj_error: float) -> int:
        from scipy.spatial import cKDTree

        pids = sorted(rec.points)
        if len(pids) < 2:
            return 0
        table = self._point_table(rec, pids)
        if table is None:
            return 0
        reg, R_all, t_all, K_all, img_row, uv, kpt, tid, mask = table
        P, T = img_row.shape
        X = np.stack([rec.points[p]["xyz"] for p in pids])

        # Per-point merge radius: thr px at the point's median viewing scale
        # (depth / focal px->3D conversion), fully vectorized.
        depth = (np.einsum("pj,ptj->pt", X, R_all[img_row][:, :, 2, :])
                 + t_all[img_row][:, :, 2])
        f = (K_all[img_row][:, :, 0, 0] + K_all[img_row][:, :, 1, 1]) * 0.5
        sc = np.where(mask & (depth > 1e-9), depth / f, np.nan)
        order = np.sort(sc, axis=1)            # NaNs sort last
        n_valid = np.sum(~np.isnan(sc), axis=1)
        med_lo = np.clip((n_valid - 1) // 2, 0, T - 1)
        med_hi = np.clip(n_valid // 2, 0, T - 1)
        rows = np.arange(P)
        scales = 0.5 * (order[rows, med_lo] + order[rows, med_hi])
        scales = np.where(n_valid > 0, scales, np.inf)
        radius = max_reproj_error * scales
        finite = np.isfinite(radius)
        if not finite.any():
            return 0
        rmax = float(np.percentile(radius[finite], 90))

        tree = cKDTree(X)
        cand = np.asarray(sorted(tree.query_pairs(rmax)), np.int64)
        if len(cand) == 0:
            return 0
        a, b = cand[:, 0], cand[:, 1]
        d = np.linalg.norm(X[a] - X[b], axis=1)
        lim = np.minimum(radius[a], radius[b])
        keep = np.isfinite(lim) & (d <= lim)
        cand = cand[keep]
        n_merged = 0
        tlen = mask.sum(axis=1)
        CH = 8192  # pairs per gate chunk (bounds the (CH, 2T, 3, 3) gathers)
        merged_this_round = np.zeros(P, bool)
        for s0 in range(0, len(cand), CH):
            ca = cand[s0 : s0 + CH, 0]
            cb = cand[s0 : s0 + CH, 1]
            n = len(ca)
            # Linkage gate (stands in for COLMAP's correspondence graph):
            #  (a) shared union-find track id (a split track — the exact
            #      case COLMAP's graph linkage covers), OR
            #  (b) a COMMON image with 2D keypoints within threshold
            #      (grid-merge / missed-match duplicates).
            # Pure 3D proximity without this gate merges real neighboring
            # structure (observed on the demo scene).
            ta = tid[ca][:, :, None]                       # (n, T, 1)
            tb = tid[cb][:, None, :]                       # (n, 1, T)
            m2 = mask[ca][:, :, None] & mask[cb][:, None, :]
            link_tid = np.any((ta == tb) & (ta >= 0) & m2, axis=(1, 2))
            same_img = (img_row[ca][:, :, None] == img_row[cb][:, None, :]) & m2
            duv = np.linalg.norm(
                uv[ca][:, :, None, :] - uv[cb][:, None, :, :], axis=-1)
            link_img = np.any(same_img & (duv <= max_reproj_error), axis=(1, 2))
            linked = link_tid | link_img

            # Union reprojection gate at the track-length-weighted centroid
            na = tlen[ca].astype(np.float64)[:, None]
            nb = tlen[cb].astype(np.float64)[:, None]
            xyz = (na * X[ca] + nb * X[cb]) / np.maximum(na + nb, 1.0)
            img_u = np.concatenate([img_row[ca], img_row[cb]], axis=1)  # (n, 2T)
            uv_u = np.concatenate([uv[ca], uv[cb]], axis=1)
            m_u = np.concatenate([mask[ca], mask[cb]], axis=1)
            Rg = R_all[img_u]                              # (n, 2T, 3, 3)
            tg = t_all[img_u]
            Kg = K_all[img_u]
            Xc = np.einsum("ntij,nj->nti", Rg, xyz) + tg
            z = Xc[..., 2]
            z_ok = np.where(m_u, z > 1e-6, True)
            zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
            uvp = np.einsum("ntij,ntj->nti", Kg, Xc / zs[..., None])[..., :2]
            err = np.linalg.norm(uvp - uv_u, axis=-1)
            err_ok = np.where(m_u, err <= max_reproj_error, True)
            track_ok = np.all(z_ok & err_ok, axis=1)

            for r in np.flatnonzero(linked & track_ok):
                ia, ib = int(ca[r]), int(cb[r])
                # Only independent merges this round; chains re-verify next
                # round against the merged state.
                if merged_this_round[ia] or merged_this_round[ib]:
                    continue
                pa, pb = pids[ia], pids[ib]
                if pa not in rec.points or pb not in rec.points:
                    continue
                A, B = rec.points[pa], rec.points[pb]
                la, lb = len(A["track"]), len(B["track"])
                keep_p, drop_p = (pa, pb) if la >= lb else (pb, pa)
                rec.merge_points(keep_p, drop_p, xyz[r])
                if hasattr(self, "track_pid"):
                    drop_tids = np.flatnonzero(self.track_pid == drop_p)
                    self.track_pid[drop_tids] = keep_p
                merged_this_round[ia] = merged_this_round[ib] = True
                n_merged += 1
        return n_merged
