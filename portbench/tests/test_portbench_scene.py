"""Scenes and tracks from a seed: the same seed gives the same inputs
(seeds above 32 bits too), tracks have the shape the refinement loop
packs, and their nodes sit on the 4 px grid within 2 px of the exact
projection."""

import numpy as np
import torch

from portbench import scene

SEED = 2 ** 33 + 5


def test_the_seed_fixes_the_scene():
    a = scene.render_scene(SEED, 3, 64, 48, "cpu")
    b = scene.render_scene(SEED, 3, 64, 48, "cpu")
    c = scene.render_scene(SEED + 1, 3, 64, 48, "cpu")
    assert torch.equal(a.images, b.images) and np.array_equal(a.K, b.K)
    assert not torch.equal(a.images, c.images)
    assert a.images.shape == (3, 48, 64)
    levels = a.images * 255
    assert torch.equal(levels, levels.round())       # 8-bit pixels
    assert float(a.images.std()) > 0.05              # textured
    assert bool((a.depths > 0).all())                # every ray hits
    f = scene.frames(a, 64)
    assert f.shape == (3, 64, 64) and bool((f[:, 48:] == 0).all())


def test_tracks():
    s = scene.render_scene(SEED, 6, 160, 120, "cpu")
    t = scene.make_tracks(s, SEED, 200, 16)
    lengths = t.node_mask.sum(1)
    assert t.node_img.shape == (200, 16) and lengths.min() >= 2
    m = t.node_mask
    assert np.all(t.node_xy[m] % 4 == 0)
    assert np.abs(t.node_xy - t.true_xy)[m].max() <= 2.0
    assert np.all(t.node_scale[:, 0] == 1.0)
    for r in range(200):                  # reference: the median scale
        sc = np.sort(t.node_scale[r, :lengths[r]])
        assert sc[len(sc) // 2] == 1.0
        views = t.node_img[r, :lengths[r]]
        assert len(set(views.tolist())) == len(views)
    assert sum(scene.histogram(t).values()) == 200
    again = scene.make_tracks(s, SEED, 200, 16)
    assert np.array_equal(again.node_xy, t.node_xy)
