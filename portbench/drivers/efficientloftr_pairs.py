"""Pairs of one scene through the program's pair-matching engine with
EfficientLoFTR (`PairMatchingEngine.match_pairs`,
`matcher="efficientloftr"`), built as `reconstruct --matcher-arch
efficientloftr --matcher-ckpt CKPT` builds it (`load_arch_params`; dense
dual-softmax; RepVGG's maps in the view store).

The published weights are not in the repository, so the weights are
seeded, drawn from the seed by the plain reference and not by the
program's init (`reference/efficientloftr.py::seeded_weights`): every
conv and Dense kernel N(0, 1) over the square root of its fan-in (the
depthwise aggregation's over 4, its fan-in's root), every BatchNorm and
LayerNorm scale 1 + 0.1 N(0, 1) and bias 0.1 N(0, 1). Each BatchNorm's
running mean and variance are then those of its input over the first two
pairs of the seed's own frames, as training leaves them, measured by the
reference's own forward in exact fp32 (with statistics drawn blind,
RepVGG's 21 blocks pass on a component common to every cell that leaves
one match a pair). The weights are written once to a checkpoint file
(`utils/checkpoint.py`) that the engine loads and the reference reads
with its own reader: the program only reads the file.

Traffic, the unit of the window and the sample: as `engine_pairs.py`'s.
Seeded weights pass few matches, so `correct` holds the timed path's own
values besides, kept by hooks for each pair of the sample (drawn from the
seed at set-up) the first time the window matches it (each step's rows
named by the frames RepVGG was handed):
  match_set_gap  the share of matches, (idx0, idx1) coarse cell pairs,
                 that one side has and the other lacks, over the union,
                 pooled over the sample;
  fine_gap_px    over the matches in both sets whose first stage did not
                 flip (below), how far the program's rounded keypoint of
                 either image lies outside the rounding cell (half the
                 round ratio, per axis) of the reference's unrounded one,
                 worst pair;
  feat_gap       the largest |difference| of the post-transformer coarse
                 features of both frames over the cells that may match,
                 worst pair;
  slot_gap_px    the largest per-axis distance between the program's
                 refined keypoints, both images, at every top-K slot of a
                 pair (valid or not) and the reference's fine stage at the
                 same (idx0, idx1), over the slots where neither first
                 stage flipped;
  slot_flips     the slots of the sample where the two sides' first-stage
                 argmax differs (a keypoint half a pixel or more apart):
                 a one-ulp difference between near-equal confidences
                 moves a keypoint by a whole pixel or more, so flips are
                 counted, not measured.
The limits, from the program's readings and the control's (the
reference in TF32 in the program's place, `control.py`) on an H100, are
in the cell's file and PERF.md.

`run_unit` also returns the reference's operations for its pairs
(`roofline_efficientloftr.py`: RepVGG once per view of the call) and the
fine fusion's operations and least bytes.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from portbench import roofline_efficientloftr as rl
from portbench.drivers.matchformer_pairs import NAME_STRIDE
from portbench.drivers.matchformer_pairs import Driver as MatchFormerDriver
from portbench.reference import efficientloftr
from portbench.scene import frames, render_scene

FLIP_PX = 0.5   # a first-stage flip moves a keypoint by a pixel or more


def seeded_checkpoint(path: str, config: dict, seed: int, views) -> str:
    """Write the reference's seeded weights, calibrated on the pairs
    (0, 1) and (0, 2) of `views` (V >= 3, F, F), as a flax checkpoint at
    `path`."""
    from detectorfreesfm_tpu_torch.utils.checkpoint import save_checkpoint

    save_checkpoint(path, efficientloftr.seeded_weights(
        config, seed, views[[0, 0]], views[[1, 2]]))
    return path


def _cells(xy, w8: int) -> np.ndarray:
    """Flat 1/8 cells of (..., 2) cell corners in pixels."""
    xy = xy.round().long()
    return ((xy[..., 1] // 8) * w8 + xy[..., 0] // 8).cpu().numpy()


class Driver(MatchFormerDriver):
    """MatchFormer's driver (`fused`, `_timed`, `info`, `release`) with
    this family's weights, hooks and comparison."""

    def setup(self, trace: bool):
        from detectorfreesfm_tpu_torch.data.images import LoadedImage
        from detectorfreesfm_tpu_torch.match.engine import (
            EngineConfig, PairMatchingEngine)
        from detectorfreesfm_tpu_torch.utils.checkpoint import (
            load_arch_params)

        c, m = self.cell, self.config
        scene = render_scene(self.seed, c["n_views"], c["width"],
                             c["height"], self.device)
        views = frames(scene, c["frame"])
        del scene
        self.frames = views.cpu().numpy()
        self.tmp = tempfile.TemporaryDirectory(prefix="efficientloftr_")
        self.weights = seeded_checkpoint(
            os.path.join(self.tmp.name, "seeded.msgpack"), m, self.seed,
            views)
        ecfg = EngineConfig(
            matcher="efficientloftr", img_resize=c["frame"],
            batch_size=c["batch_size"],
            match_threshold=m["match_threshold"], max_matches=m["top_k"],
            round_matches_ratio=m["round_matches_ratio"],
            compute_dtype=m["compute_dtype"], fused_matching=False,
            fine_enabled=m["match_type"] == "coarse_fine")
        params = load_arch_params(self.weights, "efficientloftr")
        self.engine = PairMatchingEngine(ecfg, params, device=self.device)
        wh = (c["width"], c["height"])
        names = [f"view_{i:03d}" for i in range(c["n_views"])]
        self.images = {n: LoadedImage(self.frames[i], np.ones(2, np.float32),
                                      wh, wh) for i, n in enumerate(names)}
        self.index = {n: i for i, n in enumerate(names)}
        self.pairs = [(a, b) for i, a in enumerate(names)
                      for b in names[i + 1:]]
        # The sample, drawn from the seed as `sample` draws it from a
        # window that kept every pair: only its pairs are kept, which
        # `sample` then returns whole.
        self.wanted = set(self._draw(sorted(self.pairs)))
        # Every shape of the window: two steps, so that a step is launched
        # while the one before it is collected.
        self.engine.match_pairs(self.pairs[:2 * c["batch_size"]],
                                self.images)
        model, = self.engine.models
        # The views' frames as the engine stages them, every NAME_STRIDE-th
        # pixel, to name the frames RepVGG is handed by.
        self.views = views.reshape(len(names), -1)[:, ::NAME_STRIDE].clone()
        self.names = names
        self.prints = {}     # view -> its coarse map's sampled values
        self.staged, self.step, self.held = [], {}, []
        self.keep_ns, self.keep_events = 0, []
        self.hooks = [
            model.backbone.register_forward_hook(self._named),
            model.transformer.layers[-1].cross_attention
            .register_forward_hook(self._features),
            model.fine.register_forward_hook(self._slots),
            model.register_forward_hook(self._done)]
        self.w8 = c["frame"] // 8
        self.view_flops = rl.repvgg(m, c["frame"], c["frame"])
        self.fusion = rl.fusion(m, c["frame"])

    def _draw(self, keys) -> list:
        """The sample of `keys`, drawn as `sample` draws it."""
        rng = np.random.default_rng(self.seed % (2 ** 63))
        pick = rng.choice(len(keys), min(self.cell["sample"], len(keys)),
                          replace=False)
        return [keys[i] for i in sorted(pick)]

    # -- hooks on the timed path ---------------------------------------------

    def _named(self, module, args, out):
        """Samples of RepVGG's frames and of their coarse maps, to name
        the pair stage's rows by after the call."""
        with self._timed(out[0].is_cuda):
            self.staged.append([
                t.reshape(len(t), -1)[:, ::NAME_STRIDE].clone()
                for t in (args[0], out[0])])

    def _match(self, rows, table, names=None) -> list:
        """The name of each of `rows` (N, 1, n) in `table` (V, n)."""
        hits = (rows == table[None]).all(-1).cpu().numpy()
        if not (hits.sum(1) == 1).all():
            raise RuntimeError("a row is not exactly one of the scene's "
                               "views")
        return [(names or self.names)[i] for i in hits.argmax(1)]

    def _features(self, module, args, out):
        """The last module's output: image 0's then image 1's (B, C, h8,
        w8) post-transformer features, copied on the card."""
        with self._timed(out.is_cuda):
            self.step.setdefault("feat", []).append(out.clone())

    def _slots(self, module, args, out):
        """The fine stage's cell corners and refined keypoints, (B, K, 2)
        each side."""
        with self._timed(out[0].is_cuda):
            self.step.update(xy=(args[2], args[3]),
                             kp=(out[0].clone(), out[1].clone()))

    def _done(self, module, args, out):
        """A step's rows, named by their coarse maps, and its validity."""
        t0 = time.perf_counter_ns()
        with self._timed(out.valid.is_cuda):
            self.step["rows"] = [
                v.coarse.reshape(len(v.coarse), -1)[:, ::NAME_STRIDE].clone()
                for v in args[:2]]
            self.step["valid"] = out.valid.clone()
            self.held.append(self.step)
            self.step = {}
        self.keep_ns += time.perf_counter_ns() - t0

    # -- the window -------------------------------------------------------------

    def run_unit(self, i: int) -> dict:
        c = self.cell
        n, k = len(self.pairs), c["pairs_per_call"]
        pairs = [self.pairs[(i * k + j) % n] for j in range(k)]
        out = self.engine.match_pairs(pairs, self.images)
        self.done += k
        t0 = time.perf_counter_ns()
        with self._timed(self.device.type == "cuda"):
            self._collect(out)
        self.keep_ns += time.perf_counter_ns() - t0
        missing = (set(pairs) & self.wanted) - set(self.outputs)
        if missing:
            raise RuntimeError(f"no features of {sorted(missing)[:3]}")
        hw = (c["height"], c["width"])
        views = len({v for p in pairs for v in p})
        flops = views * self.view_flops + sum(
            rl.pair(self.config, c["frame"], hw, hw, len(out[p]["kpts0"]))
            for p in pairs)
        return {"done": k, "flops": flops,
                "fusion_flops": k * self.fusion[0],
                "fusion_bytes": k * self.fusion[1]}

    def _collect(self, out):
        """Each step's rows under their pair's name: the first time a
        sampled pair is matched, its features, cells and keypoints."""
        for pixels, prints in self.staged:
            self.prints.update(zip(self._match(pixels[:, None], self.views),
                                   prints))
        self.staged = []
        named = list(self.prints)
        table = torch.stack([self.prints[n] for n in named])
        for s in self.held:
            names = [self._match(r[:, None], table, named)
                     for r in s["rows"]]
            cell0, cell1 = (_cells(xy, self.w8) for xy in s["xy"])
            valid = s["valid"].cpu().numpy()
            for r, p in enumerate(zip(*names)):
                if p not in out:
                    raise RuntimeError(f"the engine matched {p}, which the "
                                       "call did not ask for")
                if p in self.outputs or p not in self.wanted:
                    continue
                v = valid[r]
                self.outputs[p] = dict(
                    out[p], cell0=cell0[r][v], cell1=cell1[r][v],
                    slot_cell0=cell0[r], slot_cell1=cell1[r],
                    slot0=s["kp"][0][r].cpu().numpy(),
                    slot1=s["kp"][1][r].cpu().numpy(),
                    feat0=s["feat"][0][r].flatten(1).t().clone(),
                    feat1=s["feat"][1][r].flatten(1).t().clone())
        self.held = []

    # -- correct ----------------------------------------------------------------

    def reference(self, keys, precision: str = "fp32") -> dict:
        """{pair: {kpts0, kpts1 (unrounded), conf, cell0, cell1, feat0,
        feat1, slot0, slot1}} of the plain reference in `precision`; its
        fine stage at the program's slots too; the features stay on the
        device."""
        from portbench.reference import weights
        from portbench.reference.nn import PRECISIONS, exact_fp32

        c = self.cell
        W = weights.load(self.weights, self.device)
        hw = (c["height"], c["width"])
        out = {}
        with exact_fp32():
            for a, b in keys:
                f0, f1 = (torch.from_numpy(self.frames[self.index[v]]).to(
                    self.device) for v in (a, b))
                r = efficientloftr.match_pair(PRECISIONS[precision], W,
                                              self.config, f0, f1, hw, hw)
                p = self.outputs[(a, b)]
                s0, s1 = r.pop("fine_at")(*(
                    torch.from_numpy(p[k]).to(self.device)
                    for k in ("slot_cell0", "slot_cell1")))
                r.update(slot0=s0, slot1=s1,
                         cell0=r.pop("idx0"), cell1=r.pop("idx1"))
                out[(a, b)] = {k: v if k.startswith("feat") else
                               v.cpu().numpy() for k, v in r.items()}
        return out

    def as_program(self, ref: dict) -> dict:
        """Reference matches rounded as the engine returns its own, with
        its cells, features and slots at the program's slot cells (the
        control in the program's place)."""
        rounded = super().as_program(ref)
        for k, v in ref.items():
            rounded[k].update({n: v[n] for n in (
                "cell0", "cell1", "feat0", "feat1", "slot0", "slot1")})
            rounded[k].update({n: self.outputs[k][n] for n in (
                "slot_cell0", "slot_cell1")})
        return rounded

    def compare(self, program: dict, ref: dict) -> list:
        from portbench.reference.loftr import cell_mask

        c, limits = self.cell, self.cell["limits"]
        half = 0.5 * float(self.config["round_matches_ratio"])
        mask = None
        per = []
        for key in ref:
            p, r = program[key], ref[key]
            pm = {(a, b): i for i, (a, b) in enumerate(
                zip(p["cell0"].tolist(), p["cell1"].tolist()))}
            rm = {(a, b): i for i, (a, b) in enumerate(
                zip(r["cell0"].tolist(), r["cell1"].tolist()))}
            both = pm.keys() & rm.keys()
            union = len(pm.keys() | rm.keys())
            gaps = np.maximum(np.abs(p["slot0"] - r["slot0"]).max(-1),
                              np.abs(p["slot1"] - r["slot1"]).max(-1))
            flips = gaps >= FLIP_PX
            slots = dict(zip(zip(p["slot_cell0"].tolist(),
                                 p["slot_cell1"].tolist()), flips))
            fine = max([float(np.abs(p[f][pm[m]] - r[f][rm[m]]).max()) - half
                        for m in both if not slots.get(m, False)
                        for f in ("kpts0", "kpts1")] + [0.0])
            if mask is None:
                mask = cell_mask(self.w8, self.w8, (c["height"], c["width"]),
                                 self.config["border"], r["feat0"].device)
            feat = max(float((p[f].to(r[f].device).float() - r[f])[mask]
                             .abs().max()) for f in ("feat0", "feat1"))
            slot = float(gaps[~flips].max()) if (~flips).any() else 0.0
            per.append((union - len(both), union, fine, feat, slot,
                        int(flips.sum())))
        union = sum(q[1] for q in per)
        got = {"match_set_gap": (sum(q[0] for q in per) / union
                                 if union else 0.0),
               "fine_gap_px": max([q[2] for q in per] + [0.0]),
               "feat_gap": max([q[3] for q in per] + [0.0]),
               "slot_gap_px": max([q[4] for q in per] + [0.0]),
               "slot_flips": sum(q[5] for q in per)}
        # An answer fails that alone breaks a limit: its differing matches
        # over the sample's share, a gap, or its flips.
        self.failed = sum(d > limits["match_set_gap"] * union or
                          f > limits["fine_gap_px"] or
                          g > limits["feat_gap"] or
                          s > limits["slot_gap_px"] or
                          n > limits["slot_flips"]
                          for d, _, f, g, s, n in per)
        return [{"name": n, "value": v, "limit": limits[n]}
                for n, v in got.items()]
