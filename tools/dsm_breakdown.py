#!/usr/bin/env python3
"""Where the time of the fused dual-softmax passes goes, on a CUDA card.

    python3 tools/dsm_breakdown.py [--batch 2] [--tokens 10816] [--iters 20]

Builds three variants of detectorfreesfm_tpu_torch/csrc/dual_softmax.cu
into build/dsm_breakdown/ and times both passes of each with CUDA events,
in turns (full, no_epilogue, no_product, ..., full), on random features:

  full         the kernels as they are
  no_epilogue  every tile's reduction replaced by one store that keeps the
               product alive: the product, the loads and the pipeline
  no_product   every tile's wgmmas removed: the loads, the pipeline and
               the reductions of whatever the accumulators hold

The variants' outputs are meaningless; only their times are. Prints one
JSON line with the times in ms, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from detectorfreesfm_tpu_torch.ops import _build, fused_dsm  # noqa: E402

EPILOGUES = (
    "epilogue1<FAST>(d, b0, nb, m1, rb, m, s, sm, col_part, ln, tid);",
    "epilogue2(d, b0, nb, m1, lse_c, rb, lr, row, best, arg, sm,\n"
    "                       col_part, ln, tid);",
)
KEEP = "if (tid == 0) col_part[b0] = make_float2(d[0], d[ACC - 1]);"
PRODUCT = ("    issue_tile<C>(d, hi0, smem_desc(at + (tid >> 7) * a_bytes),\n"
           "                  smem_desc(bt), smem_desc(bt + b_bytes));")


def variants(src: str) -> dict:
    for text in (*EPILOGUES, PRODUCT):
        if text not in src:
            raise SystemExit(f"the source no longer has: {text!r}")
    no_epi = src
    for text in EPILOGUES:
        no_epi = no_epi.replace(text, KEEP)
    return {"full": src, "no_epilogue": no_epi,
            "no_product": src.replace(PRODUCT, "    fence_acc(d);")}


def build(name: str, text: str) -> ctypes.CDLL:
    out = os.path.join(REPO, "build", "dsm_breakdown")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, f"{name}.cu")
    so = os.path.join(out, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dsm_row_tiles.argtypes = [i]
    lib.dsm_splits.argtypes = [i, i, i]
    lib.dsm_pass1.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.dsm_pass2.argtypes = [p] * 14 + [i] * 5 + [p]
    return lib


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=10816)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    src_path = _build.CSRC / fused_dsm.SOURCE
    libs = {n: build(n, t) for n, t in variants(src_path.read_text()).items()}

    b, n, c = args.batch, args.tokens, fused_dsm.KERNEL_C
    gen = torch.Generator(device="cuda").manual_seed(0)
    f0 = torch.randn(b, n, c, device="cuda", generator=gen) * 3
    f1 = torch.randn(b, n, c, device="cuda", generator=gen) * 3
    ones = torch.ones(b, n, dtype=torch.bool, device="cuda")
    ops = fused_dsm.split_features(f0, f1, ones, ones)
    lse = torch.zeros(b, n, device="cuda")
    outs = [torch.empty(b, n, device="cuda"),
            torch.empty(b, n, dtype=torch.int32, device="cuda")] * 2
    stream = torch.cuda.current_stream().cuda_stream

    def ptrs(*ts):
        return [t.data_ptr() for t in ts]

    times = {}
    names = list(libs)
    for name in names + names[::-1]:
        lib = libs[name]
        splits = lib.dsm_splits(b, n, n)
        rows = torch.empty(b, splits, n, 2, device="cuda")
        cols = torch.empty(b, lib.dsm_row_tiles(n), n, 2, device="cuda")
        t1 = cuda_ms(lambda: lib.dsm_pass1(*ptrs(*ops, lse, lse, rows, cols),
                                           b, n, n, c, splits, 0, stream),
                     args.iters)
        t2 = cuda_ms(lambda: lib.dsm_pass2(*ptrs(*ops, lse, lse, *outs, rows,
                                                 cols),
                                           b, n, n, c, splits, stream),
                     args.iters)
        times.setdefault(name, []).append({"dsm_pass1": t1, "dsm_pass2": t2})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"batch": b, "tokens": n, "ms": times,
                      "card": smi}))


if __name__ == "__main__":
    main()
