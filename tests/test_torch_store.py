"""The port's match and model stores (h5io, colmap_io, reconstruction,
model_select, database) against the JAX package's: files written by one
read by the other, and the same bytes, rows and values (tolerance: exact,
as these are host numpy copies)."""

import os
import sqlite3

import numpy as np
import pytest

from detectorfreesfm_tpu.data import colmap_io as JC
from detectorfreesfm_tpu.data import database as JD
from detectorfreesfm_tpu.data import h5io as JH
from detectorfreesfm_tpu.sfm import model_select as JM
from detectorfreesfm_tpu.sfm import reconstruction as JR
from detectorfreesfm_tpu_torch.data import colmap_io as TC
from detectorfreesfm_tpu_torch.data import database as TD
from detectorfreesfm_tpu_torch.data import h5io as TH
from detectorfreesfm_tpu_torch.sfm import model_select as TM
from detectorfreesfm_tpu_torch.sfm import reconstruction as TR

DATA = os.path.join(os.path.dirname(__file__), "data")


def _store(rng):
    return {"a/b.jpg": rng.uniform(0, 800, (50, 2)).astype(np.float32),
            "c.jpg": rng.uniform(0, 800, (7, 2)).astype(np.float32),
            "a/b.jpg|c.jpg": rng.integers(0, 7, (9, 2)).astype(np.int32)}


def _same_store(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def test_h5io_both_branches_interoperate(tmp_path):
    """h5py branch: written by one package, read by the other. npz branch:
    the file is `path + ".npz"`, named by stored_path, written atomically
    (no .tmp left), and read back by the JAX package's npz reader."""
    d = _store(np.random.default_rng(0))
    p1, p2 = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    assert TH.save_h5(d, p1, use_h5py=True) == p1 == TH.stored_path(p1, True)
    _same_store(JH.load_h5(p1), d)
    JH.save_h5(d, p2)
    _same_store(TH.load_h5(p2), d)
    p3 = str(tmp_path / "n.h5")
    written = TH.save_h5(d, p3, use_h5py=False)
    assert written == p3 + ".npz" == TH.stored_path(p3, use_h5py=False)
    assert sorted(os.listdir(tmp_path)) == ["j.h5", "n.h5.npz", "t.h5"]
    _same_store(TH.load_h5(p3, use_h5py=False), d)
    with np.load(written) as z:  # the JAX npz reader's view of the file
        _same_store({JH._unescape(k): z[k] for k in z.files}, d)


def test_h5io_never_imports_h5py_for_npz(monkeypatch):
    """use_h5py=False takes the npz branch without importing h5py, and
    use_h5py=True raises where h5py is missing."""
    import builtins

    real = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("no h5py here")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    assert TH.stored_path("x.h5") == "x.h5.npz"
    assert TH.stored_path("x.h5", use_h5py=False) == "x.h5.npz"
    with pytest.raises(ImportError):
        TH.stored_path("x.h5", use_h5py=True)


@pytest.mark.parametrize("scene", ["demo_cached", "demo_cached_832"])
@pytest.mark.parametrize("name", ["keypoints", "matches"])
def test_npz_copies_equal_the_cached_h5(scene, name):
    """tests/data/torch/<scene>/<name>.h5.npz (written by the port's
    save_h5, npz branch) equals the JAX package's load_h5 of the original
    .h5, bit for bit, keys and dtypes included."""
    ref = JH.load_h5(os.path.join(DATA, scene, f"{name}.h5"))
    got = TH.load_h5(os.path.join(DATA, "torch", scene, f"{name}.h5"),
                     use_h5py=False)
    _same_store(got, ref)


def _model(C, rng):
    cams = {
        1: C.Camera(1, "PINHOLE", 640, 480,
                    np.array([500.0, 480.0, 320.0, 240.0])),
        2: C.Camera(2, "SIMPLE_RADIAL", 800, 600,
                    np.array([650.0, 400.0, 300.0, 0.01])),
    }
    images = {}
    for i in range(1, 5):
        q = rng.normal(size=4)
        n = int(rng.integers(0, 20)) if i != 3 else 0  # one empty image
        images[i] = C.Image(
            i, q / np.linalg.norm(q), rng.normal(size=3), 1 + (i % 2),
            f"img_{i:04d}.jpg", rng.uniform(0, 640, size=(n, 2)),
            rng.integers(-1, 50, size=(n,)).astype(np.int64))
    pts = {}
    for j in range(1, 7):
        t = int(rng.integers(1, 4))
        pts[j] = C.Point3D(
            j, rng.normal(size=3), rng.integers(0, 255, 3).astype(np.uint8),
            float(rng.uniform(0, 2)),
            rng.integers(1, 4, size=(t,)).astype(np.int32),
            rng.integers(0, 10, size=(t,)).astype(np.int32))
    return cams, images, pts


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_io_round_trips_against_jax(tmp_path, ext):
    """The same model written by both packages gives the same bytes (bin,
    txt and PLY); each package reads the other's files back to the same
    model; camera helpers (K, k1, scale_focal, rescale) agree."""
    jm = _model(JC, np.random.default_rng(1))
    tm = _model(TC, np.random.default_rng(1))
    JC.write_model(*jm, str(tmp_path / "j"), ext)
    TC.write_model(*tm, str(tmp_path / "t"), ext)
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    for mod, d in ((TC, "j"), (JC, "t")):
        c, i, p = mod.read_model(str(tmp_path / d), ext)
        assert c.keys() == jm[0].keys() and i.keys() == jm[1].keys()
        for k in i:
            np.testing.assert_array_equal(i[k].xys, jm[1][k].xys)
            np.testing.assert_array_equal(i[k].point3D_ids,
                                          jm[1][k].point3D_ids)
            np.testing.assert_array_equal(i[k].qvec, jm[1][k].qvec)
        for k in p:
            np.testing.assert_array_equal(p[k].xyz, jm[2][k].xyz)
            np.testing.assert_array_equal(p[k].image_ids, jm[2][k].image_ids)
            assert p[k].error == jm[2][k].error
    JC.write_ply(jm[2], str(tmp_path / "j.ply"))
    TC.write_ply(tm[2], str(tmp_path / "t.ply"))
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply"
                                                 ).read_bytes()
    for k in jm[0]:
        jc, tc = jm[0][k], tm[0][k]
        np.testing.assert_array_equal(tc.K(), jc.K())
        assert tc.k1() == jc.k1() and tc.model_id == jc.model_id
        jc.scale_focal(1.3)
        tc.scale_focal(1.3)
        jc.rescale(0.5, 0.7)
        tc.rescale(0.5, 0.7)
        np.testing.assert_array_equal(tc.params, jc.params)
    assert not [f for f in os.listdir(tmp_path / "t") if f.endswith(".tmp")]


def _reconstruction(C, R, rng):
    """The same edits on either package's Reconstruction."""
    rec = R.Reconstruction()
    for i in range(1, 5):
        rec.add_camera(C.Camera(i, "SIMPLE_RADIAL", 640, 480,
                                np.array([500.0, 320.0, 240.0, -0.02 * i])))
        rec.add_image(R.RImage(id=i, name=f"im{i}.jpg", camera_id=i,
                               xys=rng.uniform(0, 640, (30, 2))))
        q = rng.normal(size=4)
        rec.set_pose(i, q / np.linalg.norm(q), rng.normal(size=3) + [0, 0, 5])
    rec.images[4].qvec = None  # unregistered
    rec.images[4].tvec = None
    for j in range(20):
        track = [(int(i), int(rng.integers(0, 30)))
                 for i in rng.choice([1, 2, 3], size=int(rng.integers(2, 4)),
                                     replace=False)]
        rec.add_point(rng.normal(size=3), track, error=float(j))
    pids = sorted(rec.points)
    rec.merge_points(pids[0], pids[1], np.zeros(3))
    rec.remove_observation(pids[2], *rec.points[pids[2]]["track"][0])
    rec.remove_point(pids[3])
    rec.deregister(3)
    return rec


def test_reconstruction_equals_jax(tmp_path):
    """add/merge/remove points, deregister, reprojection errors (SIMPLE_
    RADIAL), to/from COLMAP and write: the same state and the same files."""
    jr = _reconstruction(JC, JR, np.random.default_rng(2))
    tr = _reconstruction(TC, TR, np.random.default_rng(2))
    assert tr.registered_images == jr.registered_images
    assert tr.n_observations() == jr.n_observations() > 0
    assert tr.points.keys() == jr.points.keys()
    for pid in jr.points:
        assert tr.points[pid]["track"] == jr.points[pid]["track"]
    for i in jr.images:
        np.testing.assert_array_equal(tr.images[i].point3D_ids,
                                      jr.images[i].point3D_ids)
    je, te = jr.reprojection_errors(), tr.reprojection_errors()
    assert je.keys() == te.keys()
    for k in je:
        np.testing.assert_array_equal(te[k], je[k])
    np.testing.assert_array_equal(tr.K_of_image(2), jr.K_of_image(2))
    assert tr.image_by_name("im2.jpg").id == 2
    jr.write(str(tmp_path / "j"))
    tr.write(str(tmp_path / "t"))
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    back = TR.Reconstruction.from_colmap(*TC.read_model(str(tmp_path / "j")))
    assert back.n_observations() == jr.n_observations()
    assert back._next_pid == max(jr.points) + 1
    assert not hasattr(TR.Reconstruction, "extract_colors")


def test_model_select_equals_jax(tmp_path):
    """model_stats, best_model (None entries skipped, ties by observation
    count) and best_model_dir over model subdirectories."""
    recs_j = [None, _reconstruction(JC, JR, np.random.default_rng(3)),
              _reconstruction(JC, JR, np.random.default_rng(4))]
    recs_t = [None, _reconstruction(TC, TR, np.random.default_rng(3)),
              _reconstruction(TC, TR, np.random.default_rng(4))]
    recs_t[2].deregister(2)
    recs_j[2].deregister(2)
    assert TM.best_model(recs_t) == JM.best_model(recs_j) == 1
    assert TM.best_model([None, None]) is None
    for rj, rt in zip(recs_j[1:], recs_t[1:]):
        sj, st = JM.model_stats(rj), TM.model_stats(rt)
        assert sj.keys() == st.keys()
        np.testing.assert_array_equal(list(st.values()), list(sj.values()))
    for k, r in enumerate(recs_j[1:]):
        r.write(str(tmp_path / str(k)))
    (tmp_path / "junk").mkdir()
    assert TM.best_model_dir(str(tmp_path)) == JM.best_model_dir(
        str(tmp_path)) == str(tmp_path / "0")


def _rows(path):
    con = sqlite3.connect(path)
    out = {t: sorted(con.execute(f"SELECT * FROM {t}").fetchall())
           for t in ("cameras", "images", "keypoints", "matches",
                     "two_view_geometries")}
    con.close()
    return out


@pytest.mark.parametrize("intrinsics", [False, True])
def test_database_equals_jax(tmp_path, intrinsics):
    """export_scene_to_database and the COLMAPDatabase writers/readers: the
    same rows in every table, the pair-id packing, and reads of either
    package's file."""
    rng = np.random.default_rng(5)
    names = ["b.jpg", "a.jpg", "c.jpg"]
    kps = {n: rng.uniform(0, 600, (int(rng.integers(5, 40)), 2)).astype(
        np.float32) for n in names}
    matches = {("a.jpg", "b.jpg"): rng.integers(0, 5, (6, 2)),
               ("c.jpg", "a.jpg"): rng.integers(0, 5, (4, 2))}
    sizes = {n: (640, 480) for n in names}
    K = ({n: np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]])
          for n in names} if intrinsics else None)
    JD.export_scene_to_database(str(tmp_path / "j.db"), kps, matches, sizes,
                                K)
    TD.export_scene_to_database(str(tmp_path / "t.db"), kps, matches, sizes,
                                K)
    with TD.COLMAPDatabase(str(tmp_path / "t.db")) as db:
        db.add_two_view_geometry(1, 3, np.array([[1, 2], [3, 4]]),
                                 E=np.eye(3) * 2)
    with JD.COLMAPDatabase(str(tmp_path / "j.db")) as db:
        db.add_two_view_geometry(1, 3, np.array([[1, 2], [3, 4]]),
                                 E=np.eye(3) * 2)
    assert _rows(str(tmp_path / "j.db")) == _rows(str(tmp_path / "t.db"))
    with TD.COLMAPDatabase(str(tmp_path / "j.db")) as db:
        got = (db.read_images(), db.read_keypoints(), db.read_matches())
    with JD.COLMAPDatabase(str(tmp_path / "j.db")) as db:
        ref = (db.read_images(), db.read_keypoints(), db.read_matches())
    assert got[0] == ref[0]
    for a, b in zip(got[1:], ref[1:]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in ((3, 7), (9, 2), (2 ** 31 - 2, 1)):
        pid = TD.image_ids_to_pair_id(a, b)
        assert pid == JD.image_ids_to_pair_id(a, b)
        assert TD.pair_id_to_image_ids(pid) == JD.pair_id_to_image_ids(pid)
