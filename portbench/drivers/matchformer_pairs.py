"""Pairs of one scene through the program's pair-matching engine with the
MatchFormer-class matcher (`PairMatchingEngine.match_pairs`,
`matcher="matchformer"`), built as `reconstruct --matcher-arch
matchformer --matcher-ckpt CKPT` builds it (`load_arch_params`; dense
dual-softmax, coarse only; the view store holds the frames).

No MatchFormer checkpoint exists, so the weights are seeded, drawn here
from the seed and not by the program's init (`seeded_checkpoint`): every
Dense and conv kernel N(0, 1) over the square root of its fan-in, every
bias 0.1 N(0, 1), every LayerNorm scale 1 + 0.1 N(0, 1). They are
written once to a checkpoint file (`utils/checkpoint.py`, as
`train-matcher --arch matchformer` writes one) that the engine loads and
the plain reference (`reference/matchformer.py`) reads with its own
reader.

Traffic, the unit of the window and the sample: as `engine_pairs.py`'s.
With seeded weights no confidence comes near the threshold, so the
matches are empty on both sides and prove little; `correct` holds the
last stage's features too, which the dual-softmax reads:
  feat_gap       the largest |difference| of the last stage's
                 (post-LayerNorm) features over the cells that may match
                 of both frames, worst pair of the sample. The program's
                 are the timed path's own: hooks on the matcher and its
                 last block keep each step's frames and features on the
                 card, and after the call each row is named by the view
                 whose frame it was handed;
  match_set_gap  as `engine_pairs.py` computes it, over the engine's
                 matches.
The limits, from the program's readings and the control's (the
reference in TF32 in the program's place, `control.py`) on an H100, are
in the cell's file and PERF.md.

`run_unit` also returns the reference's operations for its pairs
(`roofline_matchformer.py`: the encoder on both frames of every pair,
and the dual-softmax) and the attention cores' operations and bytes at
their roofline.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from portbench import roofline_matchformer
from portbench.drivers.engine_pairs import Driver as PairsDriver
from portbench.scene import frames, render_scene

# A prime, so that the pixels that name a frame fall on every column.
NAME_STRIDE = 61


def seeded_tree(config: dict, seed: int) -> dict:
    """MatchFormer's flax parameter tree with every leaf drawn from
    `seed`: Dense and conv kernels N(0, 1) / sqrt(fan-in), biases
    0.1 N(0, 1), LayerNorm scales 1 + 0.1 N(0, 1)."""
    g = torch.Generator().manual_seed(seed % 2 ** 63)

    def normal(*shape):
        return torch.randn(*shape, generator=g)

    def dense(n_in, n_out, bias=True):
        leaf = {"kernel": normal(n_in, n_out) / n_in ** 0.5}
        if bias:
            leaf["bias"] = 0.1 * normal(n_out)
        return leaf

    def layer_norm(c):
        return {"scale": 1.0 + 0.1 * normal(c), "bias": 0.1 * normal(c)}

    tree, cin = {}, 1
    for si, (c, blocks) in enumerate(zip(config["stage_dims"],
                                         config["stage_blocks"])):
        tree[f"embed{si}"] = {
            "kernel": normal(3, 3, cin, c) / (9 * cin) ** 0.5,
            "bias": 0.1 * normal(c)}
        for bi in range(blocks):
            for kind in ("self", "cross"):
                tree[f"s{si}_b{bi}_{kind}"] = {
                    "q": dense(c, c, False), "k": dense(c, c, False),
                    "v": dense(c, c, False), "proj": dense(c, c),
                    "ln": layer_norm(c), "mlp1": dense(c, 2 * c),
                    "mlp2": dense(2 * c, c), "ln2": layer_norm(c)}
        cin = c
    return {"params": tree}


def seeded_checkpoint(path: str, config: dict, seed: int) -> str:
    """Write `seeded_tree(config, seed)` as a flax checkpoint at `path`."""
    from detectorfreesfm_tpu_torch.utils.checkpoint import save_checkpoint

    save_checkpoint(path, seeded_tree(config, seed))
    return path


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
        self.tmp = tempfile.TemporaryDirectory(prefix="matchformer_")
        self.weights = seeded_checkpoint(
            os.path.join(self.tmp.name, "seeded.msgpack"), m, self.seed)
        ecfg = EngineConfig(
            matcher="matchformer", img_resize=c["frame"],
            batch_size=c["batch_size"],
            match_threshold=m["match_threshold"], max_matches=m["top_k"],
            round_matches_ratio=m["round_matches_ratio"],
            compute_dtype=m["compute_dtype"], fused_matching=False,
            fine_enabled=False)
        params = load_arch_params(self.weights, "matchformer")
        self.engine = PairMatchingEngine(ecfg, params, device=self.device)
        scene = render_scene(self.seed, c["n_views"], c["width"],
                             c["height"], self.device)
        views = frames(scene, c["frame"])
        self.frames = views.cpu().numpy()
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
        model, = self.engine.models
        last = len(m["stage_blocks"]) - 1
        block = getattr(model, f"s{last}_b{m['stage_blocks'][-1] - 1}_cross")
        # The views' frames as the engine stages them, every NAME_STRIDE-th
        # pixel, to name a step's rows by.
        self.views = views.reshape(len(names), -1)[:, ::NAME_STRIDE].clone()
        self.names = names
        self.held = []
        self.keep_ns, self.keep_events = 0, []
        self.hooks = [model.register_forward_pre_hook(self._hold),
                      block.register_forward_hook(self._keep)]
        hw = (c["height"], c["width"])
        self.pair_flops = roofline_matchformer.pair(m, c["frame"], hw, hw)
        self.attn = roofline_matchformer.sr_attention(m, c["frame"])

    def _hold(self, module, args):
        """A step's two sides' (B, F, F, 1) frames, as handed to the
        matcher."""
        self.held.append([args[0].frames, args[1].frames])

    def _keep(self, module, args, out):
        """The last block's (2B, N, C) output of the step, copied on the
        card."""
        t0 = time.perf_counter_ns()
        with self._timed(out.is_cuda):
            self.held[-1].append(out.clone())
        self.keep_ns += time.perf_counter_ns() - t0

    @contextlib.contextmanager
    def _timed(self, cuda: bool):
        """CUDA events around what the driver adds to the card's work."""
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            ev[0].record()
        yield
        if cuda:
            ev[1].record()
            self.keep_events.append(ev)

    def _names(self, rows) -> list:
        """The view whose frame each (F, F, 1) row is, by every
        NAME_STRIDE-th pixel."""
        pixels = rows.reshape(len(rows), -1)[:, None, ::NAME_STRIDE]
        hits = (pixels == self.views[None]).all(-1).cpu().numpy()
        if not (hits.sum(1) == 1).all():
            raise RuntimeError("the matcher was handed a frame that is not "
                               "exactly one of the scene's views")
        return [self.names[i] for i in hits.argmax(1)]

    def run_unit(self, i: int) -> dict:
        c = self.cell
        n, k = len(self.pairs), c["pairs_per_call"]
        pairs = [self.pairs[(i * k + j) % n] for j in range(k)]
        out = self.engine.match_pairs(pairs, self.images)
        self.done += k
        # Each step's rows, named by their frames: the first of each pair
        # that no earlier unit kept.
        t0 = time.perf_counter_ns()
        with self._timed(self.device.type == "cuda"):
            for rows0, rows1, feats in self.held:
                b = len(rows0)
                for r, p in enumerate(zip(self._names(rows0),
                                          self._names(rows1))):
                    if p not in out:
                        raise RuntimeError(f"the engine matched {p}, which "
                                           "the call did not ask for")
                    if p not in self.outputs:
                        self.outputs[p] = dict(out[p],
                                               feat0=feats[r].clone(),
                                               feat1=feats[b + r].clone())
            self.held = []
        self.keep_ns += time.perf_counter_ns() - t0
        missing = set(pairs) - set(self.outputs)
        if missing:
            raise RuntimeError(f"no features of {sorted(missing)[:3]}")
        return {"done": k, "flops": k * self.pair_flops,
                "sr_attn_flops": k * self.attn[0],
                "sr_attn_bytes": k * self.attn[1]}

    def info(self) -> dict:
        keep_ms = None
        if self.keep_events:
            self.keep_events[-1][1].synchronize()
            keep_ms = sum(a.elapsed_time(b) for a, b in self.keep_events)
        return dict(super().info(), features_kept=len(self.outputs),
                    keep_host_ms=self.keep_ns * 1e-6, keep_device_ms=keep_ms)

    def release(self):
        for hook in self.hooks:
            hook.remove()
        super().release()

    def reference(self, keys, precision: str = "fp32") -> dict:
        """{pair: {kpts0, kpts1, conf, feat0, feat1}} of the plain
        reference in `precision`; the features stay on the device."""
        from portbench.reference import matchformer, weights
        from portbench.reference.nn import PRECISIONS, exact_fp32

        c = self.cell
        W = weights.load(self.weights, self.device)
        hw = (c["height"], c["width"])
        out = {}
        with exact_fp32():
            for a, b in keys:
                f0, f1 = (torch.from_numpy(self.frames[self.index[v]]).to(
                    self.device) for v in (a, b))
                r = matchformer.match_pair(PRECISIONS[precision], W,
                                           self.config, f0, f1, hw, hw)
                out[(a, b)] = {k: v if k.startswith("feat") else
                               v.cpu().numpy() for k, v in r.items()}
        return out

    def as_program(self, ref: dict) -> dict:
        """Reference matches rounded as the engine returns its own, and
        its features (the control in the program's place)."""
        rounded = super().as_program(ref)
        for k, v in ref.items():
            rounded[k].update(feat0=v["feat0"], feat1=v["feat1"])
        return rounded

    def compare(self, program: dict, ref: dict) -> list:
        from portbench.reference.loftr import cell_mask

        c, limits = self.cell, self.cell["limits"]
        w8 = c["frame"] // 8
        per = []
        for key in ref:
            p, r = program[key], ref[key]
            pk, rk = ({tuple(x) for x in s["kpts0"].tolist()}
                      for s in (p, r))
            union = len(pk | rk)
            mask = cell_mask(w8, w8, (c["height"], c["width"]),
                             self.config["border"], r["feat0"].device)
            feat = max(float((p[f].to(r[f].device).float() - r[f])[mask]
                             .abs().max()) for f in ("feat0", "feat1"))
            per.append((union - len(pk & rk), union, feat))
        union = sum(u for _, u, _ in per)
        got = {"match_set_gap": (sum(d for d, _, _ in per) / union
                                 if union else 0.0),
               "feat_gap": max([f for _, _, f in per] + [0.0])}
        # An answer fails that alone breaks a limit: its feature gap, or
        # its differing keypoints over the sample's share.
        self.failed = sum(f > limits["feat_gap"] or
                          d > limits["match_set_gap"] * union
                          for d, _, f in per)
        return [{"name": n, "value": v, "limit": limits[n]}
                for n, v in got.items()]
