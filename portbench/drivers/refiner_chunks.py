"""Track chunks of one scene through the program's multiview refiner
(`MultiviewRefiner.forward`), staged as the refinement loop stages them
(`refine/loop.py::_refine_iteration`): rows of `max_track_length` node
slots in chunks of `chunk_tracks` (the last padded), host arrays moved to
the card per chunk, a one-deep dispatch/collect overlap, under the loop's
precision settings (full fp32 products, bf16 GEMMs reduced in fp32,
cuDNN on with benchmark mode and TF32 off).

Traffic (the cell's file): `n_views` views rendered at `width` x
`height`; `n_tracks` tracks of the scene's exact geometry (scene.py:
make_tracks), nodes on the 4 px grid; one pass over every chunk per
refinement window of `windows` (crop = window + `crop_extra`), in order.

One unit of the window is one pass of each window, coordinates on the
host. `correct` compares the refined coordinates of `sample` (window,
chunk) pairs drawn from the seed, as the window first produced them, with
the plain reference's:
  coord_gap_px  the largest distance, per axis, between the program's and
                the reference's coordinates of a live node.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import roofline
from portbench.scene import histogram, make_tracks, render_scene
from portbench.timing import ModuleTimer


def _pad(arr, rows, fill=0):
    if len(arr) == rows:
        return arr
    pad = np.full((rows - len(arr),) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad])


class Driver:
    END_TO_END = ("tracks_per_s", "tracks/s")

    def __init__(self, cell, config, seed, device, root):
        self.cell, self.config, self.seed = cell, config, int(seed)
        self.device, self.root = device, root
        self.outputs = {}
        self.done = 0
        self.chunks = 0
        self.timer = None
        self.failed = 0

    def setup(self, trace: bool):
        from detectorfreesfm_tpu_torch.core.precision import (
            geometry_precision)
        from detectorfreesfm_tpu_torch.device import bf16_reduced_in_fp32
        from detectorfreesfm_tpu_torch.models.multiview_matcher import (
            MultiviewRefiner, RefinerConfig)
        from detectorfreesfm_tpu_torch.parallel.mesh import (
            mesh_of, shard_leading_axis)
        from detectorfreesfm_tpu_torch.utils.checkpoint import (
            load_refiner_params)

        c, m = self.cell, self.config
        self._flags = lambda: (
            geometry_precision(), bf16_reduced_in_fp32(),
            torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                       deterministic=False,
                                       allow_tf32=False))
        self.mesh = mesh_of(self.device)
        self._shard = shard_leading_axis
        path = str(self.root / m["weights"])
        self.models = {}
        for w in c["windows"]:
            rcfg = RefinerConfig(
                crop_size=w + m["crop_extra"], window=w, d_model=m["d_model"],
                nhead=m["nhead"], n_layers=m["n_layers"],
                softmax_temperature=m["softmax_temperature"],
                compute_dtype=m["compute_dtype"])
            model = MultiviewRefiner(rcfg)
            model.load_state_dict(load_refiner_params(path, rcfg,
                                                      self.device))
            self.models[w] = model.to(self.device).eval()
        scene = render_scene(self.seed, c["n_views"], c["width"],
                             c["height"], self.device)
        self.tracks = make_tracks(scene, self.seed, c["n_tracks"],
                                  c["max_track_length"])
        self.images = scene.images[..., None].contiguous()
        del scene
        self.starts = list(range(0, c["n_tracks"], c["chunk_tracks"]))
        for w in c["windows"]:            # every shape of the window
            self._dispatch(w, 0)[3].coords.cpu()
        if trace:
            ms = list(self.models.values())
            self.timer = ModuleTimer(
                {"s2dnet": [mm.backbone for mm in ms],
                 "transformer": [mm.transformer for mm in ms]}, self.device)
        lengths = self.tracks.node_mask.sum(1)
        self.flops = {w: sum(roofline.refiner_track(m, int(n), w)
                             for n in lengths) for w in c["windows"]}

    # -- the window -------------------------------------------------------------

    def _dispatch(self, window, start):
        t, rows = self.tracks, self.cell["chunk_tracks"]
        end = min(start + rows, len(t.node_img))
        (batch,) = self._shard(
            (_pad(t.node_img[start:end], rows),
             _pad(t.node_xy[start:end], rows),
             _pad(t.node_scale[start:end], rows, 1.0),
             _pad(t.node_mask[start:end], rows)), self.mesh)
        a, b, c = self._flags()
        with a, b, c, torch.no_grad():
            out = self.models[window](self.images, *batch)
        return window, start, end - start, out

    def _collect(self, window, start, n, out):
        coords = out.coords.cpu()[:n].numpy()
        self.outputs.setdefault((window, start), coords)
        return n

    def run_unit(self, i: int) -> dict:
        done = 0
        for w in self.cell["windows"]:
            pending = None
            for start in self.starts:
                nxt = self._dispatch(w, start)
                if pending is not None:
                    done += self._collect(*pending)
                pending = nxt
            done += self._collect(*pending)
        self.done += done
        self.chunks += len(self.starts) * len(self.cell["windows"])
        return {"done": done, "flops": sum(self.flops.values())}

    def counters(self) -> dict:
        return {"tracks": self.done, "chunks": self.chunks}

    def hook_ms(self) -> dict:
        return self.timer.total_ms() if self.timer else {}

    def info(self) -> dict:
        c = self.cell
        return {"cell": c["name"], "seed": self.seed,
                "tracks": int(len(self.tracks.node_img)),
                "chunks_per_pass": len(self.starts),
                "windows": list(c["windows"]),
                "track_length_histogram": histogram(self.tracks)}

    def release(self):
        if self.timer:
            self.timer.remove()
        self.models = None

    # -- correct ----------------------------------------------------------------

    def sample(self) -> list:
        keys = sorted(self.outputs)
        rng = np.random.default_rng(self.seed % (2 ** 63))
        pick = rng.choice(len(keys), min(self.cell["sample"], len(keys)),
                          replace=False)
        return [keys[i] for i in sorted(pick)]

    def reference(self, keys, precision: str = "fp32") -> dict:
        """{(window, start): (n, V, 2) coordinates} of the plain reference
        in `precision`."""
        from portbench.reference import refiner, weights
        from portbench.reference.nn import PRECISIONS, exact_fp32

        W = weights.load(str(self.root / self.config["weights"]),
                         self.device)
        t, rows = self.tracks, self.cell["chunk_tracks"]
        images = self.images[..., 0]
        out = {}
        with exact_fp32():
            for w, start in keys:
                sl = slice(start, start + rows)
                args = [torch.from_numpy(a[sl]).to(self.device) for a in (
                    t.node_img, t.node_xy, t.node_scale, t.node_mask)]
                out[(w, start)] = refiner.refine(
                    PRECISIONS[precision], W, self.config, images, *args,
                    w).cpu().numpy()
        return out

    def as_program(self, ref: dict) -> dict:
        return ref

    def compare(self, program: dict, ref: dict) -> list:
        limit = self.cell["limits"]["coord_gap_px"]
        worst, self.failed = 0.0, 0
        for (w, start), r in ref.items():
            mask = self.tracks.node_mask[start:start + len(r)]
            gap = float(np.abs(program[(w, start)] - r)[mask].max())
            self.failed += gap > limit
            worst = max(worst, gap)
        return [{"name": "coord_gap_px", "value": worst, "limit": limit}]

    def check(self) -> list:
        keys = self.sample()
        return self.compare(self.outputs, self.reference(keys))

    def failed_answers(self) -> int:
        return self.failed
