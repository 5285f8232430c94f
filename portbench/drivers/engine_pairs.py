"""Pairs of one scene through the program's pair-matching engine
(`PairMatchingEngine.match_pairs`), built as the `reconstruct` and
`eval-dataset` verbs build it on the card.

Traffic (the cell's file): `n_views` views of a scene rendered at `width`
x `height` and padded into a `frame` square; all exhaustive pairs, taken
in calls of `pairs_per_call` that wrap around the list; `batch_size`
pairs a step; the dual-softmax as the verbs' `--fused auto` picks it (the
CUDA passes above 12 000 coarse cells, on the card).

One unit of the window is one call, results on the host. `correct`
compares the matches of `sample` pairs drawn from the seed, as the window
first produced them, with the plain reference's:
  match_set_gap  the share of image-0 keypoints (the coarse cells matched)
                 that one side has and the other lacks, over the union of
                 both sides' keypoints, pooled over the sample;
  fine_gap_px    over the keypoints in both sets, how far the program's
                 rounded image-1 keypoint lies outside the rounding cell
                 (half the round ratio, per axis) of the reference's
                 unrounded one, worst pair.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import roofline
from portbench.scene import frames, render_scene
from portbench.timing import ModuleTimer

FUSED_AUTO_CELLS = 12000  # the verbs' `--fused auto` threshold


class Driver:
    END_TO_END = ("pairs_per_s", "pairs/s")

    def __init__(self, cell, config, seed, device, root):
        self.cell, self.config, self.seed = cell, config, int(seed)
        self.device, self.root = device, root
        self.outputs = {}
        self.done = 0
        self.timer = None
        self.failed = 0
        n = cell["n_views"] * (cell["n_views"] - 1) // 2
        if cell["pairs_per_call"] > n:
            raise ValueError("a call may not hold a pair twice")

    # -- set-up ---------------------------------------------------------------

    def fused(self) -> bool:
        return (self.device.type == "cuda" and
                (self.cell["frame"] // 8) ** 2 > FUSED_AUTO_CELLS)

    def setup(self, trace: bool):
        from detectorfreesfm_tpu_torch.data.images import LoadedImage
        from detectorfreesfm_tpu_torch.match.engine import (
            EngineConfig, PairMatchingEngine)
        from detectorfreesfm_tpu_torch.utils.checkpoint import (
            load_matcher_params)

        c, m = self.cell, self.config
        ecfg = EngineConfig(
            matcher="loftr", img_resize=c["frame"],
            batch_size=c["batch_size"],
            match_threshold=m["match_threshold"], max_matches=m["top_k"],
            round_matches_ratio=m["round_matches_ratio"],
            compute_dtype=m["compute_dtype"], fused_matching=self.fused(),
            fine_enabled=m["match_type"] == "coarse_fine")
        params = load_matcher_params(str(self.root / m["weights"]),
                                     ecfg.matcher_config())
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
        if trace:
            model = self.engine.models
            self.timer = ModuleTimer(
                {"backbone": [mm.backbone for mm in model],
                 "coarse_transformer": [mm.coarse_transformer
                                        for mm in model]}, self.device)
        hw = (c["height"], c["width"])
        live = roofline.live_cells(*hw, m["border"])
        self.dsm = roofline.dual_softmax(live, live, m["d_coarse"])

    # -- the window -------------------------------------------------------------

    def run_unit(self, i: int) -> dict:
        c = self.cell
        n, k = len(self.pairs), c["pairs_per_call"]
        pairs = [self.pairs[(i * k + j) % n] for j in range(k)]
        out = self.engine.match_pairs(pairs, self.images)
        self.done += k
        hw = (c["height"], c["width"])
        flops = 0
        for p in pairs:
            self.outputs.setdefault(p, out[p])
            flops += roofline.loftr_pair(self.config, c["frame"], hw, hw,
                                         len(out[p]["kpts0"]))
        return {"done": k, "flops": flops, "dsm_flops": k * self.dsm[0],
                "dsm_bytes": k * self.dsm[1]}

    def counters(self) -> dict:
        return {"pairs": self.done}

    def hook_ms(self) -> dict:
        return self.timer.total_ms() if self.timer else {}

    def info(self) -> dict:
        c = self.cell
        return {"cell": c["name"], "seed": self.seed,
                "pairs_in_scene": len(self.pairs), "fused": self.fused(),
                "frame": c["frame"], "image": [c["width"], c["height"]]}

    def release(self):
        if self.timer:
            self.timer.remove()
        self.engine = None

    # -- correct ----------------------------------------------------------------

    def sample(self) -> list:
        keys = sorted(self.outputs)
        rng = np.random.default_rng(self.seed % (2 ** 63))
        pick = rng.choice(len(keys), min(self.cell["sample"], len(keys)),
                          replace=False)
        return [keys[i] for i in sorted(pick)]

    def reference(self, keys, precision: str = "fp32") -> dict:
        """{pair: {kpts0, kpts1 (unrounded), conf}} of the plain
        reference in `precision`."""
        from portbench.reference import loftr, weights
        from portbench.reference.nn import PRECISIONS, exact_fp32

        c = self.cell
        W = weights.load(str(self.root / self.config["weights"]),
                         self.device)
        hw = (c["height"], c["width"])
        out = {}
        with exact_fp32():
            for a, b in keys:
                f0 = torch.from_numpy(self.frames[self.index[a]]).to(
                    self.device)
                f1 = torch.from_numpy(self.frames[self.index[b]]).to(
                    self.device)
                r = loftr.match_pair(PRECISIONS[precision], W, self.config,
                                     f0, f1, hw, hw)
                out[(a, b)] = {k: v.cpu().numpy() for k, v in r.items()}
        return out

    def as_program(self, ref: dict) -> dict:
        """Reference matches rescaled and rounded as the engine returns
        its own (the control in the program's place)."""
        r = float(self.config["round_matches_ratio"])
        return {k: {"kpts0": np.round(v["kpts0"] / r) * r,
                    "kpts1": np.round(v["kpts1"] / r) * r,
                    "conf": v["conf"]} for k, v in ref.items()}

    def compare(self, program: dict, ref: dict) -> list:
        half = 0.5 * float(self.config["round_matches_ratio"])
        limits = self.cell["limits"]
        per = []
        for key in ref:
            p, r = program[key], ref[key]
            pk = [tuple(x) for x in p["kpts0"].tolist()]
            rk = {tuple(x): y for x, y in zip(r["kpts0"].tolist(),
                                              r["kpts1"])}
            u = len(set(pk) | rk.keys())
            fine = 0.0
            for x, y in zip(pk, p["kpts1"]):
                if x in rk:
                    fine = max(fine, float(np.abs(y - rk[x]).max()) - half)
            per.append((u - len(set(pk) & rk.keys()), u, fine))
        union = sum(u for _, u, _ in per)
        got = {"match_set_gap": (sum(d for d, _, _ in per) / union
                                 if union else 0.0),
               "fine_gap_px": max([f for _, _, f in per] + [0.0])}
        # An answer fails that alone breaks a limit: its fine gap, or its
        # differing keypoints over the sample's share.
        self.failed = sum(f > limits["fine_gap_px"] or
                          d > limits["match_set_gap"] * union
                          for d, _, f in per)
        return [{"name": n, "value": v, "limit": limits[n]}
                for n, v in got.items()]

    def check(self) -> list:
        keys = self.sample()
        return self.compare(self.outputs, self.reference(keys))

    def failed_answers(self) -> int:
        return self.failed
