"""Track-bag packing: group feature tracks into refiner batches.

Port of the JAX package's refine/bags.py (numpy only). Host-side
equivalent of the reference's MatchingMultiviewData scheduler
(src/post_optimization/data_construct/construct_matching_data.py:162-283):
greedily take the longest remaining track, let its observing images define a
bag, pull in every other track whose views fall inside the bag, and chunk
bags to a track budget. Reference-view selection per track follows the
reference's `midium_scale` strategy (coarse_sfm_refinement_dataset.py:236-301):
the view whose focal/depth scale is the median over the track.

`pack_track_table` is what the refinement loop uses: one flat scene-wide
table of padded (T, V) rows, every row independent in the refiner forward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..core.geometry import np_quat_to_rotmat
from ..sfm.reconstruction import Reconstruction


@dataclasses.dataclass
class TrackBag:
    image_ids: List[int]              # bag images (reconstruction ids)
    point_ids: List[int]              # 3D point per track row (live rows)
    node_img: np.ndarray              # (T, V) int32 index into image_ids
    node_xy: np.ndarray               # (T, V, 2) float32, original pixels
    node_scale: np.ndarray            # (T, V) float32 relative scale
    node_mask: np.ndarray             # (T, V) bool
    node_kpt: np.ndarray              # (T, V) int32 keypoint index (or -1)


def _point_view_scales(rec: Reconstruction, pid: int) -> List[Tuple[int, int, float]]:
    """[(image_id, kpt_idx, scale=f/depth)] for each observation."""
    out = []
    pt = rec.points[pid]
    for img_id, kpt in pt["track"]:
        im = rec.images[img_id]
        if not im.registered:
            continue
        K = rec.K_of_image(img_id)
        R = np_quat_to_rotmat(np.asarray(im.qvec, np.float64))
        depth = float((R @ pt["xyz"] + im.tvec)[2])
        if depth <= 1e-6:
            continue
        f = float((K[0, 0] + K[1, 1]) * 0.5)
        out.append((img_id, kpt, f / depth))
    return out


def _build_entries(rec: Reconstruction, max_track_length: int,
                   min_track_length: int):
    """Per-point node lists with reference-first ordering (median-scale
    reference view, reference coarse_sfm_refinement_dataset.py:236-301)."""
    entries = []  # (pid, [(img, kpt, rel_scale)] ref first)
    for pid in sorted(rec.points):
        obs = _point_view_scales(rec, pid)
        if len(obs) < min_track_length:
            continue
        obs = obs[:max_track_length]
        scales = np.asarray([s for _, _, s in obs])
        ref_i = int(np.argsort(scales, kind="stable")[len(scales) // 2])
        ref = obs[ref_i]
        rest = [o for k, o in enumerate(obs) if k != ref_i]
        # relative scale: node_scale / ref_scale (crop dilation factor)
        nodes = [(ref[0], ref[1], 1.0)] + [
            (i, k, s / ref[2]) for (i, k, s) in rest
        ]
        entries.append((pid, nodes))
    return entries


@dataclasses.dataclass
class TrackTable:
    """Flat scene-wide track tensor: every track row is independent in the
    refiner forward, so no bag structure is needed — the whole image set
    sits in device memory and rows are chunked. (The reference's image bags
    exist to bound per-GPU image loads — construct_matching_data.py:226-283;
    here they would only fragment the batch.)"""

    image_ids: List[int]              # global image list (index target)
    point_ids: List[int]
    node_img: np.ndarray              # (T, V) int32 index into image_ids
    node_xy: np.ndarray               # (T, V, 2) float32
    node_scale: np.ndarray            # (T, V) float32
    node_mask: np.ndarray             # (T, V) bool
    node_kpt: np.ndarray              # (T, V) int32


def pack_track_table(
    rec: Reconstruction,
    max_track_length: int = 16,
    min_track_length: int = 2,
) -> TrackTable:
    cfg_V = max_track_length
    entries = _build_entries(rec, max_track_length, min_track_length)
    image_ids = sorted(rec.images)
    img_index = {im: i for i, im in enumerate(image_ids)}
    T = len(entries)
    node_img = np.zeros((T, cfg_V), np.int32)
    node_xy = np.zeros((T, cfg_V, 2), np.float32)
    node_scale = np.ones((T, cfg_V), np.float32)
    node_mask = np.zeros((T, cfg_V), bool)
    node_kpt = np.full((T, cfg_V), -1, np.int32)
    pids = []
    for r, (pid, nodes) in enumerate(entries):
        pids.append(pid)
        for vpos, (img_id, kpt, rel) in enumerate(nodes[:cfg_V]):
            node_img[r, vpos] = img_index[img_id]
            node_xy[r, vpos] = rec.images[img_id].xys[kpt]
            node_scale[r, vpos] = rel
            node_mask[r, vpos] = True
            node_kpt[r, vpos] = kpt
    return TrackTable(
        image_ids=image_ids, point_ids=pids, node_img=node_img,
        node_xy=node_xy, node_scale=node_scale, node_mask=node_mask,
        node_kpt=node_kpt,
    )


def pack_track_bags(
    rec: Reconstruction,
    max_track_length: int = 16,
    max_imgs_per_bag: int = 16,
    chunk_tracks: int = 2000,
    min_track_length: int = 2,
) -> List[TrackBag]:
    cfg_V = max_track_length
    entries = _build_entries(rec, max_track_length, min_track_length)

    # Greedy bag assignment: longest track first. The seed's bag images are
    # taken in node order (reference view first), so when a long track's view
    # set exceeds max_imgs_per_bag the reference view always stays in the bag
    # and only trailing query views are dropped.
    order = sorted(range(len(entries)), key=lambda i: -len(entries[i][1]))
    consumed = np.zeros(len(entries), bool)
    bags_raw: List[Tuple[List[int], List[int]]] = []  # (img_ids, entry_idxs)
    track_imgs = [sorted({i for i, _, _ in nodes}) for _, nodes in entries]
    for seed in order:
        if consumed[seed]:
            continue
        seed_imgs_ordered = []
        for i, _, _ in entries[seed][1]:
            if i not in seed_imgs_ordered:
                seed_imgs_ordered.append(i)
        bag_imgs = seed_imgs_ordered[:max_imgs_per_bag]
        bag_set = set(bag_imgs)
        members = [seed]
        consumed[seed] = True
        for j in order:
            if consumed[j]:
                continue
            if set(track_imgs[j]) <= bag_set:
                members.append(j)
                consumed[j] = True
        bags_raw.append((bag_imgs, members))

    # Chunk + tensorize
    bags: List[TrackBag] = []
    for bag_imgs, members in bags_raw:
        img_index = {im: i for i, im in enumerate(bag_imgs)}
        for start in range(0, len(members), chunk_tracks):
            chunk = members[start : start + chunk_tracks]
            T = len(chunk)
            node_img = np.zeros((T, cfg_V), np.int32)
            node_xy = np.zeros((T, cfg_V, 2), np.float32)
            node_scale = np.ones((T, cfg_V), np.float32)
            node_mask = np.zeros((T, cfg_V), bool)
            node_kpt = np.full((T, cfg_V), -1, np.int32)
            pids = []
            for r, ei in enumerate(chunk):
                pid, nodes = entries[ei]
                pids.append(pid)
                # Seed tracks longer than the bag keep only in-bag views
                nodes = [nd for nd in nodes if nd[0] in img_index]
                for vpos, (img_id, kpt, rel) in enumerate(nodes[:cfg_V]):
                    node_img[r, vpos] = img_index[img_id]
                    node_xy[r, vpos] = rec.images[img_id].xys[kpt]
                    node_scale[r, vpos] = rel
                    node_mask[r, vpos] = True
                    node_kpt[r, vpos] = kpt
            bags.append(TrackBag(
                image_ids=bag_imgs, point_ids=pids, node_img=node_img,
                node_xy=node_xy, node_scale=node_scale, node_mask=node_mask,
                node_kpt=node_kpt,
            ))
    return bags
