#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (detectorfreesfm_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout; imports only the
standard library, numpy, torch and the port. Phases, one JSON line each:

  device   card name and power limit
  build    nvcc of the port's CUDA sources into build/torch_kernels/, and
           the count of tensor-core (HGMMA) instructions in the library
  kernels  each kernel against its plain torch version at a ragged shape,
           the main path's (B=2, L=S=10816, C=256) and the 1600 px one
           (B=1, L=S=40000), timed at the last two; planted ties across
           row and column tiles resolve to the first index
  weights  the bundled r5 matcher through the port's converter
  main     6 exhaustive pairs of a 832 px synthetic scene, coarse_fine,
           through PairMatchingEngine with the fused kernels, held to the
           dense path and to the JAX engine's recorded numbers

Any failed check raises (non-zero exit). The last two lines are the
kernels summary and {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(REPO, "weights", "demo_matcher_r5_bf16.msgpack")

# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 on the tensor
# cores and HBM3 bandwidth. The kernels run three bf16 products (hi/lo
# halves) on the tensor cores.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# The dense fp32 JAX engine on the CPU, same scene and settings, recorded
# with `python tests/test_torch_engine.py --size 832` (PERF.md).
JAX_TOTAL_VALID = 12288          # 2048 (the top-K capacity) on each pair
JAX_MEDIAN_EPIPOLAR_PX = 1.0242514909205727

MAIN_SHAPE = dict(b=2, l=10816, s=10816, c=256)
RAGGED_SHAPE = dict(b=2, l=1000, s=777, c=256)
ETH3D_SHAPE = dict(b=1, l=40000, s=40000, c=256)  # 1600 px, one pair
# Device kernels of csrc/dual_softmax.cu, as the profiler names them.
DSM_KERNELS = ("pass1_kernel", "pass2_kernel", "combine1_kernel",
               "combine2_kernel")
N_PARAMS_R5 = 11265288


def check(ok, *what):
    """A check of the run; raises (not an assert, which -O would drop)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    """Mean device ms of fn() over iters launches, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def iou(a, b):
    return len(a & b) / max(len(a | b), 1)


def match_set(m, b):
    v = m.valid[b].cpu().numpy()
    return set(zip(m.idx0[b].cpu().numpy()[v].tolist(),
                   m.idx1[b].cpu().numpy()[v].tolist()))


def row_set(m):
    return {tuple(r) for r in np.concatenate([m["kpts0"], m["kpts1"]],
                                             1).tolist()}


def features(b, l, s, c, seed):
    """Features with post-transformer statistics of the r5 matcher (token
    norm ~42 with a large shared component, logits ~5..70), and planted
    mutual matches."""
    from detectorfreesfm_tpu_torch.ops.dual_softmax import border_mask

    rng = np.random.default_rng(seed)
    common = rng.normal(0, 1, c)
    common *= 30.0 / np.linalg.norm(common)
    f0 = common + rng.normal(0, 1.8, (b, l, c))
    f1 = common + rng.normal(0, 1.8, (b, s, c))
    n = min(1200, min(l, s) // 3)  # below K, so no ties at the top-K cut
    for i in range(b):
        src = rng.choice(l, n, replace=False)
        dst = rng.choice(s, n, replace=False)
        f1[i, dst] = f0[i, src] + rng.normal(0, 0.6, (n, c))
    side = int(round(l ** 0.5))
    if side * side == l and l == s:
        m0 = border_mask(side, side, 2)[None].expand(b, -1).clone()
        m1 = m0.clone()
    else:
        m0 = torch.from_numpy(rng.uniform(size=(b, l)) > 0.05)
        m1 = torch.from_numpy(rng.uniform(size=(b, s)) > 0.05)
    dev = torch.device("cuda")
    return (torch.tensor(f0, dtype=torch.float32, device=dev),
            torch.tensor(f1, dtype=torch.float32, device=dev),
            m0.to(dev), m1.to(dev))


def bound(shape, pass2):
    """(bound ms, bound_by) of one pass: three bf16 products on the tensor
    cores against its bytes (each input read once, each output written
    once): the four feature halves, the masks, pass 2's lse inputs, and
    the outputs (two lse vectors; or a max and an arg per row and column)."""
    b, l, s, c = shape["b"], shape["l"], shape["s"], shape["c"]
    flops = 3 * 2.0 * b * l * s * c
    vec = 4.0 * b * (l + s)
    nbytes = 2 * 2.0 * b * (l + s) * c + vec + (3 * vec if pass2 else vec)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check_kernels(shape, seed, timed):
    from detectorfreesfm_tpu_torch.ops import fused_dsm as K

    f0, f1, m0, m1 = features(seed=seed, **shape)
    ops = K.split_features(f0, f1, m0, m1, 0.1)
    out = {}

    lse_r, lse_c = K.dsm_pass1(*ops)
    ref_r, ref_c = K.dsm_pass1_plain(*ops)
    err_lse = max((lse_r - ref_r)[m0].abs().max().item(),
                  (lse_c - ref_c)[m1].abs().max().item())
    check(err_lse <= 2e-3, "dsm_pass1 vs plain", err_lse)

    rmax, rarg, cmax, carg = K.dsm_pass2(*ops, ref_r, ref_c)
    pr_max, pr_arg, pc_max, pc_arg = K.dsm_pass2_plain(*ops, ref_r, ref_c)
    agree_r = (rarg == pr_arg)[m0].float().mean().item()
    agree_c = (carg == pc_arg)[m1].float().mean().item()
    err_max = max((rmax - pr_max)[m0].abs().max().item(),
                  (cmax - pc_max)[m1].abs().max().item())
    check(min(agree_r, agree_c) >= 0.995, "argmax agreement", agree_r,
          agree_c)
    del pr_max, pr_arg, pc_max, pc_arg

    plain_stats = K.dual_softmax_stats_plain(f0, f1, m0, m1, 0.1)
    plain = K.matches_from_stats(plain_stats, m0, 0.2, 2048)
    del plain_stats
    ious = {}
    for fast in (False, True):
        fused = K.fused_extract_matches(f0, f1, m0, m1, 0.2, 2048, 0.1, fast)
        ious[fast] = min(iou(match_set(fused, b), match_set(plain, b))
                         for b in range(shape["b"]))
    check(ious[False] >= 0.95 and ious[True] >= 0.90, "match IoU", ious)
    check(min(len(match_set(plain, b)) for b in range(shape["b"])) > 100,
          "too few planted matches found")

    out.update(shape=shape, lse_max_abs_err=err_lse,
               argmax_max_abs_err=err_max, row_arg_agree=agree_r,
               col_arg_agree=agree_c, match_iou=ious[False],
               match_iou_fast_exp=ious[True])
    if timed:
        for name, fn, plain_fn, pass2, err in (
                ("dsm_pass1", lambda: K.dsm_pass1(*ops),
                 lambda: K.dsm_pass1_plain(*ops), False, err_lse),
                ("dsm_pass2", lambda: K.dsm_pass2(*ops, ref_r, ref_c),
                 lambda: K.dsm_pass2_plain(*ops, ref_r, ref_c), True,
                 err_max)):
            bound_ms, bound_by = bound(shape, pass2)
            ms = cuda_ms(fn, 10)
            out[name] = dict(ms=ms, plain_ms=cuda_ms(plain_fn, 3),
                             bound_ms=bound_ms, bound_by=bound_by,
                             share_of_bound=bound_ms / ms, max_abs_err=err)
    return out


def check_ties():
    """Identical f0 rows in row tiles 0, 2 and 14 tie for the maximum of
    one column, and identical f1 rows in column tiles 0, 1 and 10 for the
    maximum of one row: both passes' kernels, like the plain versions,
    give the first index."""
    from detectorfreesfm_tpu_torch.ops import fused_dsm as K

    rng = np.random.default_rng(7)
    n, c = 1000, 256
    f0 = rng.normal(0, 1, (1, n, c))
    f1 = rng.normal(0, 1, (1, n, c))
    v, w = (x * 40.0 / np.linalg.norm(x) for x in rng.normal(0, 1, (2, c)))
    tie_rows, col = [3, 130, 900], 11
    row, tie_cols = 500, [5, 70, 700]
    f0[0, tie_rows] = v
    f1[0, col] = v
    f0[0, row] = w
    f1[0, tie_cols] = w
    dev = torch.device("cuda")
    f0, f1 = (torch.tensor(x, dtype=torch.float32, device=dev)
              for x in (f0, f1))
    ones = torch.ones(1, n, dtype=torch.bool, device=dev)
    ops = K.split_features(f0, f1, ones, ones, 0.1)
    zeros = torch.zeros(1, n, device=dev)
    got = K.dsm_pass2(*ops, zeros, zeros)
    want = K.dsm_pass2_plain(*ops, zeros, zeros)
    check(got[3][0, col].item() == tie_rows[0]
          and want[3][0, col].item() == tie_rows[0], "column tie",
          got[3][0, col].item(), want[3][0, col].item())
    check(got[1][0, row].item() == tie_cols[0]
          and want[1][0, row].item() == tie_cols[0], "row tie",
          got[1][0, row].item(), want[1][0, row].item())
    check(bool((got[1] == want[1]).all()) and bool((got[3] == want[3]).all()),
          "tie case: kernel and plain argmaxes differ")
    return {"column_tie_arg": got[3][0, col].item(),
            "row_tie_arg": got[1][0, row].item()}


def profile_batch(engine, pairs, images):
    """Device time by kernel for one warm batch, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    engine.match_pairs(pairs, images)
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.match_pairs(pairs, images)
            torch.cuda.synchronize()
    except RuntimeError as e:  # no CUPTI tracing on this machine
        return {"not_measured": repr(e)}
    wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    # The two passes' sweeps and their combines, whatever their rank.
    dsm = [e for e in kernels if any(k in e.key for k in DSM_KERNELS)]
    # wall_ms includes the profiler's own start-up: no idle share from it.
    return dict(pairs=len(pairs), wall_ms=wall_ms, device_ms=dev_ms,
                dual_softmax_ms=sum(e.self_device_time_total
                                    for e in dsm) / 1e3,
                dual_softmax=[(e.key[:60], e.count,
                               e.self_device_time_total / 1e3) for e in dsm],
                top=[(e.key[:90], e.count, e.self_device_time_total / 1e3)
                     for e in top])


def main_path(params):
    from detectorfreesfm_tpu_torch.data.images import from_array
    from detectorfreesfm_tpu_torch.data.synthetic import (
        SyntheticConfig,
        fundamental_matrix,
        generate_scene,
        symmetric_epipolar_error,
    )
    from detectorfreesfm_tpu_torch.match.engine import (
        EngineConfig,
        PairMatchingEngine,
    )
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs
    from detectorfreesfm_tpu_torch.ops import fused_dsm
    from detectorfreesfm_tpu_torch.ops.grid_merge import (
        merge_matches_to_keypoints,
    )

    t0 = time.time()
    imgs, _depths, K, q, t = generate_scene(
        0, SyntheticConfig(size=832, n_views=4))
    names = [f"view_{i}" for i in range(len(imgs))]
    images = {n: from_array(imgs[i]) for i, n in enumerate(names)}
    pairs = exhaustive_pairs(names)
    render_s = time.time() - t0

    def engine(fused):
        return PairMatchingEngine(EngineConfig(
            img_resize=832, fine_enabled=True, round_matches_ratio=4,
            fused_matching=fused, batch_size=2), params)

    fused_engine = engine(True)
    fused_engine.match_pairs(pairs, images)  # warm-up (cuDNN, kernels)
    torch.cuda.synchronize()
    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0
    t0 = time.time()
    raw = fused_engine.match_pairs(pairs, images)
    keypoints, _scores, match_indices = merge_matches_to_keypoints(raw)
    torch.cuda.synchronize()
    fused_s = time.time() - t0
    launches = dict(fused_dsm.launches)
    # One dsm_pass1 and one dsm_pass2 per batch of 2 pairs.
    check(launches == {"dsm_pass1": 3, "dsm_pass2": 3},
          "kernel launches on the main path", launches)
    check(set(raw) == set(pairs) and set(keypoints) == set(names),
          "pairs or images missing from the output")

    profile = profile_batch(fused_engine, pairs[:2], images)

    dense_engine = engine(False)
    t0 = time.time()
    dense = dense_engine.match_pairs(pairs, images)
    torch.cuda.synchronize()
    dense_s = time.time() - t0
    ious = {f"{a}-{b}": iou(row_set(raw[(a, b)]), row_set(dense[(a, b)]))
            for a, b in pairs}
    check(min(ious.values()) >= 0.95, "fused vs dense IoU", ious)

    counts, errs = {}, []
    for (a, b), m in raw.items():
        i, j = names.index(a), names.index(b)
        F = fundamental_matrix(K[i], q[i], t[i], K[j], q[j], t[j])
        counts[f"{a}-{b}"] = len(m["conf"])
        errs.append(symmetric_epipolar_error(F, m["kpts0"], m["kpts1"]))
    median = float(np.median(np.concatenate(errs)))
    total = sum(counts.values())
    check(all(np.isfinite(m["kpts1"]).all() for m in raw.values()),
          "non-finite keypoints")
    check(total >= 0.9 * JAX_TOTAL_VALID, "valid matches", total,
          JAX_TOTAL_VALID)
    check(median <= JAX_MEDIAN_EPIPOLAR_PX + 0.5, "epipolar median", median,
          JAX_MEDIAN_EPIPOLAR_PX)
    return dict(render_s=render_s, fused_match_s=fused_s,
                dense_match_s=dense_s, pairs=len(pairs),
                fused_pairs_per_s=len(pairs) / fused_s,
                valid_per_pair=counts, total_valid=total,
                jax_total_valid=JAX_TOTAL_VALID, median_epipolar_px=median,
                jax_median_epipolar_px=JAX_MEDIAN_EPIPOLAR_PX,
                iou_fused_vs_dense=ious,
                n_keypoints={n: len(k) for n, k in keypoints.items()},
                n_index_matches=sum(len(v) for v in match_indices.values()),
                launches=launches, profile_one_batch=profile)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from detectorfreesfm_tpu_torch.device import set_fp32_backends
    from detectorfreesfm_tpu_torch.ops import _build, fused_dsm
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params

    set_fp32_backends()  # plain versions' matmuls in full fp32, as the kernels
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        smi = "nvidia-smi not available"
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.time()
    so = _build.build(fused_dsm.SOURCE)
    _build.load(fused_dsm.SOURCE)
    build_s = time.time() - t0
    hgmma = _build.sass_count(so, "HGMMA")
    log = so.with_suffix(".log").read_text() if so.with_suffix(
        ".log").exists() else ""
    emit({"phase": "build", "seconds": build_s, "library": so.name,
          "hgmma_instructions": hgmma,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Performance Loss" in ln]})
    check(hgmma > 0, "no HGMMA instruction: the product is not on the "
          "tensor cores")

    t0 = time.time()
    ragged = check_kernels(RAGGED_SHAPE, seed=1, timed=False)
    main_k = check_kernels(MAIN_SHAPE, seed=0, timed=True)
    eth3d = check_kernels(ETH3D_SHAPE, seed=2, timed=True)
    ties = check_ties()
    emit({"phase": "kernels", "seconds": time.time() - t0,
          "ragged": ragged, "main_shape": main_k, "eth3d_1600px": eth3d,
          "ties": ties})

    t0 = time.time()
    params = load_matcher_params(WEIGHTS)
    n_params = sum(v.numel() for k, v in params.items()
                   if not k.endswith(("running_mean", "running_var")))
    check(n_params == N_PARAMS_R5, "parameter count", n_params)
    emit({"phase": "weights", "seconds": time.time() - t0,
          "n_params": n_params})

    t0 = time.time()
    main_res = main_path(params)
    emit({"phase": "main", "seconds": time.time() - t0, **main_res})

    replaces = {
        "dsm_pass1": "detectorfreesfm_tpu/ops/pallas_dsm.py:98 (_pass1_kernel)",
        "dsm_pass2": "detectorfreesfm_tpu/ops/pallas_dsm.py:160 "
                     "(_pass2_kernel)",
    }
    src = "detectorfreesfm_tpu_torch/csrc/dual_softmax.cu"
    kernels = []
    for kname in ("dsm_pass1", "dsm_pass2"):
        k = main_k[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces[kname],
            "launches": main_res["launches"][kname],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None})
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
