"""Nothing a run loads has the top-level name jax, jaxlib, flax or
detectorfreesfm_tpu (compared whole: the port's own name begins with the
JAX package's), and the references load nothing of the port at all."""

import json
import os
import shutil
import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import ROOT

RUN = """
import json, os, sys
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests.tiny import TINY
for cell in {cells!r}:
    with open(os.devnull, "w") as out:
        harness.run(cell, 3, 0, False, device="cpu", overrides=TINY[cell],
                    out=out)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.reference import loftr, msgpack, nn, refiner, weights
from portbench import roofline, trace
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    cells = ["loftr_ds_r5.scene16_832", "mvrefiner_r4.tracks_832"]
    names = _top_names(RUN.format(root=ROOT, cells=cells))
    assert "detectorfreesfm_tpu_torch" in names     # the program ran
    assert not names & set(harness.BANNED)


def test_the_references_load_nothing_of_the_program():
    names = _top_names(REFERENCE.format(root=ROOT))
    assert not names & {"jax", "jaxlib", "flax", "detectorfreesfm_tpu",
                        "detectorfreesfm_tpu_torch"}


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "detectorfreesfm_tpu_torch", sys)
    assert harness.banned_modules() == [] or all(
        m.split(".")[0] in harness.BANNED for m in harness.banned_modules())
    before = set(harness.banned_modules())
    monkeypatch.setitem(sys.modules, "detectorfreesfm_tpu.ops", sys)
    assert set(harness.banned_modules()) - before == {
        "detectorfreesfm_tpu.ops"}


def test_no_card_no_result(tmp_path):
    """Where torch sees no card (here), or the checkout holds only the
    benchmark, a run exits non-zero and prints nothing on stdout."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "loftr_ds_r5.scene16_832", "--seed", "7", "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, timeout=300,
            cwd=cwd, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert out.stdout.strip() == ""
