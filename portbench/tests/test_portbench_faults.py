"""A run whose timed path is broken underneath reports `correct` false
at the committed limits, once for each fault its cell can have; the same
run unbroken reports true. Tiny shapes on the CPU: the harness's look for
a card is skipped by passing the device."""

import io

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import TINY

ENGINE = "loftr_ds_r5.scene16_832"
REFINER = "mvrefiner_r4.tracks_832"


def _run(cell, seed=2 ** 31 + 101):
    return harness.run(cell, seed, 0, False, device="cpu",
                       overrides=TINY[cell], out=io.StringIO())


def _break_matcher(monkeypatch, fault):
    from detectorfreesfm_tpu_torch.models.loftr import (DetectorFreeMatcher,
                                                        MatchOutput)

    forward = DetectorFreeMatcher.forward

    def broken(self, *args, **kw):
        out = forward(self, *args, **kw)
        c0, c1, conf, valid = (t.clone() for t in out)
        b = valid.shape[0]
        if fault == "half_batch":        # half the pairs of a step skipped
            valid[b // 2:] = False
        elif fault == "altered":         # one match moved where produced
            i = int(valid[0].nonzero()[0, 0])
            c1[0, i] += 16.0
        return MatchOutput(c0, c1, conf, valid)

    monkeypatch.setattr(DetectorFreeMatcher, "forward", broken)


def _break_refiner(monkeypatch, fault):
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        MultiviewRefiner, RefinerOutput)

    forward = MultiviewRefiner.forward

    def broken(self, images, node_img, node_xy, node_scale, node_mask):
        out = forward(self, images, node_img, node_xy, node_scale, node_mask)
        coords = out.coords.clone()
        t = coords.shape[0]
        if fault == "unchanged":         # the step returns its input
            coords = node_xy.clone()
        elif fault == "half_batch":      # half the chunk's tracks skipped
            coords[t // 2:] = node_xy[t // 2:]
        elif fault == "altered":         # one node moved where produced
            r, v = (node_mask[:, 1:]).nonzero()[0].tolist()
            coords[r, v + 1, 0] += 1.0
        return RefinerOutput(coords, out.std)

    monkeypatch.setattr(MultiviewRefiner, "forward", broken)


def test_sound_runs_are_correct():
    assert _run(ENGINE)["correct"] is True
    assert _run(REFINER)["correct"] is True


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_matching_faults_are_caught(monkeypatch, fault):
    _break_matcher(monkeypatch, fault)
    result = _run(ENGINE)
    assert result["correct"] is False
    assert result["failed"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_refinement_faults_are_caught(monkeypatch, fault):
    _break_refiner(monkeypatch, fault)
    result = _run(REFINER)
    assert result["correct"] is False
    assert result["failed"] >= 1


def _control(cell, device, overrides=None, seed=2 ** 31 + 202):
    """The TF32 control in the program's place: the comparison a run makes,
    of the reference in TF32 against the reference in float32."""
    spec = harness.load_json("workloads", cell)
    spec.update(overrides or {})
    config = harness.load_json("configs", spec["config"])
    d = harness.load_driver(spec["driver"])(spec, config, seed, device,
                                            harness.ROOT)
    d.setup(False)
    d.run_unit(0)
    d.release()
    keys = d.sample()
    checks = d.compare(d.as_program(d.reference(keys, "tf32")),
                       d.reference(keys, "fp32"))
    return {c["name"]: c["value"] > c["limit"] for c in checks}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [ENGINE, REFINER,
                                  "loftr_ds_r5.eth3d_1600"])
def test_control_fails_at_the_cells_size(cell):
    """On the card, at the cell's own shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    assert any(_control(cell, torch.device("cuda", 0)).values())


def test_refinement_control_fails_on_the_cpu():
    """The TF32 control in the program's place fails the refinement cell's
    limit at tiny shapes too (the matching cells' need the card's: at 96
    px too few matches lie near a threshold or a rounding edge)."""
    assert any(_control(REFINER, torch.device("cpu"),
                        TINY[REFINER]).values())
