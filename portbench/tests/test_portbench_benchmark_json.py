"""BENCHMARK.json keeps to the benchmark's contract and names the files
the harness finds: each configuration's file, each cell's workload file,
each per-layer metric's reader with the same unit, layer, source and
end-to-end metric."""

import json
import os
import re

from portbench import harness
from portbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_shape_of_the_file():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    for key, keys in KEYS.items():
        for e in b[key]:
            extra = set(e) - keys
            assert extra <= ({"workloads"} if key in ("end_to_end",
                                                      "per_layer")
                             else set()), (key, e["name"], extra)
            assert keys <= set(e), (key, e["name"])
            assert NAME.match(e["name"]), e["name"]
    names = [e["name"] for k in ("end_to_end", "per_layer")
             for e in b[k]]
    assert len(names) == len(set(names))
    os.stat(os.path.join(ROOT, "BENCHMARK.json"))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_configs_and_cells_name_their_files():
    b = _bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert w["config"] in configs and _line(w["why"])
        assert w["chips"] == 1 and NAME.match(w["traffic"])
        spec = harness.load_json("workloads", w["name"])
        assert (spec["config"], spec["traffic"], spec["chips"],
                spec["why"]) == (w["config"], w["traffic"], w["chips"],
                                 w["why"])
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)


def test_metrics_name_their_readers():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    readers = harness.load_metrics()
    assert set(readers) == {m["name"] for m in b["per_layer"]}
    for m in b["per_layer"]:
        r = readers[m["name"]]
        assert (r.UNIT, r.LAYER, r.SOURCE, r.MOVES) == (
            m["unit"], m["layer"], m["source"], m["moves"]), m["name"]
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                             cells))
    for w in b["workloads"]:
        driver = harness.load_driver(harness.load_json(
            "workloads", w["name"])["driver"])
        reported = [m["name"] for m in b["end_to_end"]
                    if w["name"] in m.get("workloads", cells)]
        assert reported == [driver.END_TO_END[0], "setup_s"]
