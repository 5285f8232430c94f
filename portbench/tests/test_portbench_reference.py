"""The plain references agree with the port on the CPU at tiny sizes with
the bundled weights: the same matches through the port's engine (the
benchmark's comparison reads 0), and refined coordinates within float32
rounding. The TF32 control departs from both."""

import os

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import nn, refiner, weights
from portbench.tests.conftest import ROOT
from portbench.tests.tiny import TINY


def _driver(cell, seed):
    spec = harness.load_json("workloads", cell)
    spec.update(TINY[cell])
    config = harness.load_json("configs", spec["config"])
    return harness.load_driver(spec["driver"])(
        spec, config, seed, torch.device("cpu"), harness.ROOT)


@pytest.mark.parametrize("cell", ["loftr_ds_r5.scene16_832",
                                  "mvrefiner_r4.tracks_832"])
def test_program_equals_reference(cell):
    d = _driver(cell, 2 ** 31 + 17)
    d.setup(False)
    d.run_unit(0)
    d.release()
    keys = sorted(d.outputs)
    checks = d.compare(d.outputs, d.reference(keys))
    for c in checks:
        assert c["value"] <= 1e-4, c


def test_matches_are_many_and_the_engine_rounds_them():
    d = _driver("loftr_ds_r5.scene16_832", 5)
    d.setup(False)
    d.run_unit(0)
    for out in d.outputs.values():
        assert len(out["kpts0"]) > 10
        assert np.all(out["kpts1"] % 4 == 0)


def test_refiner_reference_against_the_port_module():
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        MultiviewRefiner, RefinerConfig)
    from detectorfreesfm_tpu_torch.utils.checkpoint import (
        load_refiner_params)

    path = os.path.join(ROOT, "weights", "demo_refiner_r4_bf16.msgpack")
    W = weights.load(path, "cpu")
    g = torch.Generator().manual_seed(0)
    images = torch.rand(4, 60, 80, generator=g)
    node_img = torch.randint(0, 4, (6, 5), generator=g)
    node_xy = torch.round(torch.rand(6, 5, 2, generator=g) *
                          torch.tensor([80.0, 60.0]) / 4) * 4
    scale = 0.7 + 0.6 * torch.rand(6, 5, generator=g)
    mask = torch.rand(6, 5, generator=g) > 0.3
    mask[:, 0] = True
    mask[-1] = False
    cfg = dict(crop_extra=4, nhead=8, softmax_temperature=0.1)
    for window in (15, 11):
        rc = RefinerConfig(crop_size=window + 4, window=window)
        model = MultiviewRefiner(rc)
        model.load_state_dict(load_refiner_params(path, rc, device="cpu"))
        with nn.exact_fp32():
            port = model.eval()(images[..., None], node_img, node_xy, scale,
                                mask).coords
            ref = refiner.refine(nn.FP32, W, cfg, images, node_img, node_xy,
                                 scale, mask, window)
            ctl = refiner.refine(nn.TF32, W, cfg, images, node_img, node_xy,
                                 scale, mask, window)
        assert (port - ref).abs().max() < 2e-5
        assert (ctl - ref).abs().max() > 1e-4
        moved = (ref - node_xy).abs()[mask].max()
        assert moved > 0.1                    # the refiner does move nodes
        assert torch.equal(ref[~mask], node_xy[~mask])


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.14159265])
    r = nn.tf32_round(x)
    assert r[0] == 1.0 and r[2] == 1.0 + 2 ** -10
    assert r[1] == 1.0 + 2 ** -10            # ties away from zero
    assert abs(r[3] - x[3]) <= 2 ** -10 * 2
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
