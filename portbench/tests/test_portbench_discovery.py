"""A configuration, a cell, a driver and a per-layer metric added only as
new files to a copy of the benchmark are found by name and run, and no
file that was there changes."""

import hashlib
import json
import os
import shutil

import torch

from portbench import harness
from portbench.tests.conftest import ROOT
from portbench.tests.tiny import TINY

METRIC = '''"""Pairs the window completed (a test metric)."""
UNIT = "pairs"
LAYER = "test"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(ctx):
    return float(ctx.counters["pairs"])
'''


def _digests(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path, capsys):
    here = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(here)

    config = json.loads((here / "configs" / "loftr_ds_r5.json").read_text())
    config["name"] = "loftr_copy"
    (here / "configs" / "loftr_copy.json").write_text(json.dumps(config))
    cell = json.loads((here / "workloads" /
                       "loftr_ds_r5.scene16_832.json").read_text())
    cell.update(TINY["loftr_ds_r5.scene16_832"], name="loftr_copy.tiny",
                config="loftr_copy", traffic="tiny",
                driver="engine_pairs_copy")
    (here / "workloads" / "loftr_copy.tiny.json").write_text(
        json.dumps(cell))
    shutil.copy(here / "drivers" / "engine_pairs.py",
                here / "drivers" / "engine_pairs_copy.py")
    (here / "metrics" / "pairs_seen.py").write_text(METRIC)

    result = harness.run("loftr_copy.tiny", 11, 0, True, device="cpu",
                         here=here)
    assert result["correct"] is True
    assert result["metrics"]["pairs_seen"]["value"] >= 6   # two calls
    after = _digests(here)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        "configs/loftr_copy.json", "workloads/loftr_copy.tiny.json",
        "drivers/engine_pairs_copy.py", "metrics/pairs_seen.py"}
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["checks"]


def test_unknown_names_are_refused():
    for kind, name in (("workloads", "no_such_cell"),
                       ("configs", "no_such_config")):
        try:
            harness.load_json(kind, name)
        except harness.Refused:
            continue
        raise AssertionError(f"{kind}/{name} was found")


def test_every_committed_cell_names_its_files():
    names = {p[:-5] for p in os.listdir(harness.HERE / "workloads")}
    metrics = harness.load_metrics()
    assert metrics
    for name in names:
        cell = harness.load_json("workloads", name)
        assert cell["name"] == name
        config = harness.load_json("configs", cell["config"])
        assert config["name"] == cell["config"]
        assert (harness.HERE / "drivers" / f"{cell['driver']}.py").is_file()
        assert os.path.isfile(os.path.join(ROOT, config["weights"]))
    for mod in metrics.values():
        assert mod.UNIT and mod.LAYER and mod.SOURCE and mod.MOVES
    assert torch.device("cpu")
