"""How the mapper answers a near-identical match set: chip_smoke.py's run C
scene (write_scene at 1040 px, 6 views) through `reconstruct
--refine-iters 0` on the CPU, matched dense at batch 1 by the JAX CLI and
by the port, dense at batch 8 and fused at batch 8 (`--fused on`, the
kernels' plain versions) by the port, and the JAX CLI's mapper on the
port's fused matches. Prints one JSON line: per run the points, the
coarse mean reprojection error and AUC@5, and the IoU of the fused and
the dense match set of each pair. About 20 minutes on a CPU:

    JAX_PLATFORMS=cpu python tests/run_fused_mapper_check.py [--work DIR]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from detectorfreesfm_tpu import cli as jax_cli  # noqa: E402
from detectorfreesfm_tpu_torch import cli as port_cli  # noqa: E402
from detectorfreesfm_tpu_torch.data.h5io import load_h5  # noqa: E402
from detectorfreesfm_tpu_torch.pipeline import match_stores  # noqa: E402


def match_sets(out):
    """{pair key: set of ((x0, y0), (x1, y1))} of a run's match store."""
    kp_path, mt_path = match_stores(out)
    kps, mts = load_h5(kp_path), load_h5(mt_path)
    sets = {}
    for key, ids in mts.items():
        a, b = key.split("|")
        sets[key] = {(tuple(kps[a][i]), tuple(kps[b][j])) for i, j in ids}
    return sets


def main(work):
    scene = os.path.join(work, "scene")
    chip_smoke.write_scene(scene, n_views=chip_smoke.RECON_SCALE_VIEWS)
    port = ("--device", "cpu")
    runs = {
        "jax_dense_b1": (jax_cli.main, ()),
        "port_dense_b1": (port_cli.main, port),
        "port_dense_b8": (port_cli.main, port + ("--match-batch-size", "8")),
        "port_fused_b8": (port_cli.main, port + ("--match-batch-size", "8",
                                                 "--fused", "on")),
    }
    report = {}

    def run(tag, main_fn, extra):
        got, _ = chip_smoke.run_reconstruct(
            main_fn, scene, os.path.join(work, tag), "--refine-iters", "0",
            *extra)
        report[tag] = dict(n_points=got["result"]["n_points"],
                           coarse_reproj_px=got["coarse"]["mean_reproj_px"],
                           auc5=got["result"]["pose_auc"]["auc@5"])

    for tag, (main_fn, extra) in runs.items():
        run(tag, main_fn, extra)
    # The JAX package's mapper on the port's fused matches.
    dst = os.path.join(work, "jax_on_fused_matches")
    os.makedirs(dst)
    for p in match_stores(os.path.join(work, "port_fused_b8")):
        for f in (p, p + ".npz"):
            if os.path.exists(f):
                shutil.copy(f, dst)
    run("jax_on_fused_matches", jax_cli.main, ())
    dense = match_sets(os.path.join(work, "port_dense_b8"))
    fused = match_sets(os.path.join(work, "port_fused_b8"))
    report["iou_fused_vs_dense"] = {
        k: len(dense[k] & fused[k]) / max(len(dense[k] | fused[k]), 1)
        for k in sorted(dense)}
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=None,
                    help="keep the scene and the outputs here")
    args = ap.parse_args()
    if args.work:
        os.makedirs(args.work, exist_ok=True)
        main(args.work)
    else:
        with tempfile.TemporaryDirectory() as d:
            main(d)
