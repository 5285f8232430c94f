#!/usr/bin/env python3
"""Why a sharded bundle adjustment needs batch-invariant, contiguous
per-observation terms to equal the one-device solve bit for bit.

    python3 tools/mesh_determinism.py          (on a machine with a card)

Prints one JSON object (with the card's name and power limit):

  bmm_rows_equal   {batch: whether the first rows of one batched 3x3
                   product of `batch` matrices equal the rows of the same
                   product over 105 000}: cuBLAS picks another kernel, and
                   rounds otherwise, past some batch size;
  ba               {iterations: max |difference| of (qvec, tvec, intr,
                   points, cost) between the 60-camera problem of
                   chip_smoke.py solved unsharded and on [cuda:0, cuda:0],
                   twice each (u2, m1, m2 against u1)}, with the port's
                   sfm/ba.py as it is;
  ba_strided_terms the same with `_obs_terms` returning jacfwd's strided
                   views of A and B (as before they were made contiguous),
                   1 LM iteration.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def bmm_rows_equal(n=105000, sizes=(1000, 52000, 65535, 65536, 80000)):
    g = torch.Generator().manual_seed(0)
    R = torch.randn(n, 3, 3, generator=g).cuda()
    X = torch.randn(n, 3, 1, generator=g).cuda()
    full = R @ X
    return {m: bool(torch.equal(R[:m] @ X[:m], full[:m])) for m in sizes}


def ba_diffs(iters):
    import chip_smoke as cs
    from detectorfreesfm_tpu_torch.parallel.mesh import make_mesh
    from detectorfreesfm_tpu_torch.sfm.ba import bundle_adjust

    args, kw, _K = cs.ba_synthetic(60, 15000, 3)
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    out = {}
    for n in iters:
        res = {name: bundle_adjust(*args, **dict(kw, max_iters=n), **where)
               for name, where in (("u1", {"device": "cuda:0"}),
                                   ("u2", {"device": "cuda:0"}),
                                   ("m1", {"mesh": mesh}),
                                   ("m2", {"mesh": mesh}))}
        out[n] = {k: [float(np.abs(np.asarray(a) - np.asarray(b)).max())
                      for a, b in zip(res["u1"], v)]
                  for k, v in res.items() if k != "u1"}
    return out


def main():
    if not torch.cuda.is_available():
        print("mesh_determinism: CUDA is not available", file=sys.stderr)
        return 2
    from detectorfreesfm_tpu_torch.sfm import ba

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "bmm_rows_equal": bmm_rows_equal(),
           "ba": ba_diffs((1, 2, 15))}
    contiguous = ba._obs_terms

    def strided(cam_R, cam_t, intr, points, obs_uv, obs_cam, obs_pt,
                huber_delta):
        R0, t0 = cam_R[obs_cam], cam_t[obs_cam]
        K0, X0 = intr[obs_cam], points[obs_pt]
        zc = torch.zeros(len(obs_uv), ba.CAM_DOF, device=X0.device)
        zp = torch.zeros(len(obs_uv), 3, device=X0.device)
        r = ba._residuals(zc, zp, R0, t0, K0, X0, obs_uv)
        A, B = ba._jacobians_ab(zc, zp, R0, t0, K0, X0, obs_uv)
        return r, A, B, contiguous(cam_R, cam_t, intr, points, obs_uv,
                                   obs_cam, obs_pt, huber_delta)[3]

    ba._obs_terms = strided
    try:
        out["ba_strided_terms"] = ba_diffs((1,))
    finally:
        ba._obs_terms = contiguous
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
