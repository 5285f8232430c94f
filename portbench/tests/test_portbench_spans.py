"""The per-layer metrics that read the program's own spans and counters
(utils/profiler.py), in a traced run of each cell at its tiny size on the
CPU: the engine's host time and the refiner's live-slot share are
reported; the two device times, which need CUDA events, are left out."""

import io
import json

import pytest

from portbench import harness
from portbench.tests.tiny import TINY

DEVICE_ONLY = ("dsm_ms_per_pair", "fine_ms_per_pair")


def _traced(cell):
    out = io.StringIO()
    result = harness.run(cell, 2 ** 31 + 77, 0, True, device="cpu",
                         overrides=TINY[cell], out=out)
    info = json.loads(out.getvalue().splitlines()[0])
    return result, info


@pytest.mark.parametrize("cell", ["loftr_ds_r5.scene16_832",
                                  "loftr_ds_r5.eth3d_1600"])
def test_match_cells_report_the_engine_host_time(cell):
    result, _info = _traced(cell)
    metrics = result["metrics"]
    assert result["correct"] is True
    assert metrics["engine_host_ms_per_pair"]["value"] > 0
    assert metrics["engine_host_ms_per_pair"]["unit"] == "ms/pair"
    assert not set(DEVICE_ONLY) & set(metrics)
    assert "refiner_live_slot_pct" not in metrics


def test_refine_cell_reports_the_live_slot_share():
    """The share is the tracks' nodes over the slots of their padded
    chunks, whatever number of passes the traced stretch held."""
    cell = "mvrefiner_r4.tracks_832"
    result, info = _traced(cell)
    metrics = result["metrics"]
    assert result["correct"] is True
    nodes = sum(int(k) * c for k, c in
                info["track_length_histogram"].items())
    slots = (info["chunks_per_pass"] * TINY[cell]["chunk_tracks"] *
             harness.load_json("workloads", cell)["max_track_length"])
    share = metrics["refiner_live_slot_pct"]["value"]
    assert 0 < share <= 100
    assert share == pytest.approx(100.0 * nodes / slots)
    assert not {"engine_host_ms_per_pair", *DEVICE_ONLY} & set(metrics)
