"""Pairs of one scene through the program's pair-matching engine with the
ASpan-class matcher (`PairMatchingEngine.match_pairs`, `matcher="aspan"`),
built as `reconstruct --matcher-arch aspan --matcher-ckpt CKPT` builds it
(`load_arch_params`; dense dual-softmax, coarse only).

Traffic, the unit of the window and the sample: as `engine_pairs.py`'s.
`correct` compares the sample's matches with the plain reference's
(`reference/aspan.py`):
  match_set_gap  the share of matches (an image-0 keypoint and its
                 image-1 keypoint, both on the 8 px cell grid) that one
                 side has and the other lacks, over the union of both
                 sides' matches, pooled over the sample: with no fine
                 stage the image-1 keypoint is discrete too, so a match
                 is held whole;
  conf_gap       the mean |confidence difference| over the matches in
                 both sets, pooled over the sample.
The flow target is rounded to a window cell, so a difference of one ulp
can move a window and the matches near it: a few matches of a pair
appear or vanish, and a few confidences move by up to ~0.04 where float32
products merely sum in another order. The largest difference is set by
those few (0.018-0.043 for the program, 0.074-0.126 for the TF32
control, on an H100), so the mean is held: it moves with every match.

`run_unit` also returns the reference's operations for its pairs
(`roofline_aspan.py`, the backbone once per view of the call) and the
flow heads' operations and bytes at their roofline.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import roofline_aspan
from portbench.drivers.engine_pairs import Driver as PairsDriver
from portbench.scene import frames, render_scene


class Driver(PairsDriver):

    def fused(self) -> bool:
        return False   # the fused kernels are the LoFTR family's

    def setup(self, trace: bool):
        from detectorfreesfm_tpu_torch.data.images import LoadedImage
        from detectorfreesfm_tpu_torch.match.engine import (
            EngineConfig, PairMatchingEngine)
        from detectorfreesfm_tpu_torch.utils.checkpoint import (
            load_arch_params)

        c, m = self.cell, self.config
        ecfg = EngineConfig(
            matcher="aspan", img_resize=c["frame"],
            batch_size=c["batch_size"],
            match_threshold=m["match_threshold"], max_matches=m["top_k"],
            round_matches_ratio=m["round_matches_ratio"],
            compute_dtype=m["compute_dtype"], fused_matching=False,
            fine_enabled=False)
        params = load_arch_params(str(self.root / m["weights"]), "aspan")
        self.engine = PairMatchingEngine(ecfg, params, device=self.device)
        scene = render_scene(self.seed, c["n_views"], c["width"],
                             c["height"], self.device)
        self.frames = frames(scene, c["frame"]).cpu().numpy()
        del scene
        wh = (c["width"], c["height"])
        names = [f"view_{i:03d}" for i in range(c["n_views"])]
        self.images = {n: LoadedImage(self.frames[i], np.ones(2, np.float32),
                                      wh, wh) for i, n in enumerate(names)}
        self.index = {n: i for i, n in enumerate(names)}
        self.pairs = [(a, b) for i, a in enumerate(names)
                      for b in names[i + 1:]]
        # Every shape of the window: two steps, so that a step is launched
        # while the one before it is collected.
        self.engine.match_pairs(self.pairs[:2 * c["batch_size"]],
                                self.images)
        hw = (c["height"], c["width"])
        self.pair_flops = roofline_aspan.pair(m, c["frame"], hw, hw)
        self.view_flops = roofline_aspan.backbone_coarse(
            c["frame"], c["frame"], m["initial_dim"], m["block_dims"])
        self.flow = roofline_aspan.flow_heads(m, c["frame"])

    def run_unit(self, i: int) -> dict:
        c = self.cell
        n, k = len(self.pairs), c["pairs_per_call"]
        pairs = [self.pairs[(i * k + j) % n] for j in range(k)]
        out = self.engine.match_pairs(pairs, self.images)
        self.done += k
        for p in pairs:
            self.outputs.setdefault(p, out[p])
        views = len({v for p in pairs for v in p})
        return {"done": k,
                "flops": views * self.view_flops + k * self.pair_flops,
                "flow_flops": k * self.flow[0],
                "flow_bytes": k * self.flow[1]}

    def reference(self, keys, precision: str = "fp32") -> dict:
        """{pair: {kpts0, kpts1, conf}} of the plain reference in
        `precision`."""
        from portbench.reference import aspan, weights
        from portbench.reference.nn import PRECISIONS, exact_fp32

        c = self.cell
        W = weights.load(str(self.root / self.config["weights"]),
                         self.device)
        hw = (c["height"], c["width"])
        out = {}
        with exact_fp32():
            for a, b in keys:
                f0, f1 = (torch.from_numpy(self.frames[self.index[v]]).to(
                    self.device) for v in (a, b))
                r = aspan.match_pair(PRECISIONS[precision], W, self.config,
                                     f0, f1, hw, hw)
                out[(a, b)] = {k: v.cpu().numpy() for k, v in r.items()}
        return out

    def compare(self, program: dict, ref: dict) -> list:
        limits = self.cell["limits"]
        per = []
        for key in ref:
            sides = [{tuple(k0) + tuple(k1): float(c) for k0, k1, c in
                      zip(s["kpts0"].tolist(), s["kpts1"].tolist(),
                          s["conf"])}
                     for s in (program[key], ref[key])]
            both = sides[0].keys() & sides[1].keys()
            union = len(sides[0].keys() | sides[1].keys())
            gap = sum(abs(sides[0][m] - sides[1][m]) for m in both)
            per.append((union - len(both), union, gap, len(both)))
        union = sum(p[1] for p in per)
        common = sum(p[3] for p in per)
        got = {"match_set_gap": (sum(p[0] for p in per) / union
                                 if union else 0.0),
               "conf_gap": sum(p[2] for p in per) / common if common else 0.0}
        # An answer fails that alone breaks a limit: its differing matches,
        # or its summed confidence differences, over the sample's share.
        self.failed = sum(d > limits["match_set_gap"] * union or
                          g > limits["conf_gap"] * common
                          for d, _, g, _ in per)
        return [{"name": n, "value": v, "limit": limits[n]}
                for n, v in got.items()]
