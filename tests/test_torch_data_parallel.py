"""Data-parallel training and evaluation over a torch.distributed group of
two CPU processes (gloo over local TCP), as a caller such as `torchrun`
would set it up: the group is initialised by the worker, never by the
port.

One spawned run (two processes of this file in `--worker` mode, with a
time limit, as tests/test_dcn_dryrun.py spawns its dryrun) does three
things in each rank, and the tests read what the ranks wrote:

  1. one MatcherTrainer step (64 px planar pairs, one coarse layer, the
     fine stage on) with a 4-row global batch split 2 + 2 over the ranks;
  2. `train-matcher` through the port's cli.main, 2 steps on two scenes,
     each rank taking one scene index, writing its own checkpoint and
     --log-json;
  3. run_eval_scenes over 5 scenes strided over the ranks.

Before the gradients were summed over the group, every rank stepped on its
own rows: on that tree test 2 fails (the ranks' checkpoints differ from
the second step on) and test 1 too (each rank's step is its half-batch
mean).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, TESTS)

WORLD = 2
ROWS = 4
SCENES = [f"scene_{i}" for i in range(5)]


def _small_matcher_cfg(fine=True):
    from detectorfreesfm_tpu_torch.models.loftr import MatcherConfig
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        MatcherTrainConfig)
    from detectorfreesfm_tpu_torch.train.optimizers import OptimConfig

    return MatcherTrainConfig(
        matcher=MatcherConfig(n_coarse_layers=1, max_matches=32, border=1,
                              fine_enabled=fine),
        optim=OptimConfig(canonical_lr=5e-4, true_batch_size=ROWS,
                          milestones=(1000,)), n_fine=16)


def _scene_fn(s):
    """A deterministic stand-in for reconstructing one scene."""
    i = SCENES.index(s)
    return {"status": "ok", "n_registered": 3 + i % 2, "n_images": 4,
            "pose_auc": {"auc@5": 0.1 * i, "auc@10": 0.05 * i + 0.5}}


def _worker(rank, port, work):
    """One rank: the three jobs of the module docstring, in one group."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    from detectorfreesfm_tpu_torch import cli
    from detectorfreesfm_tpu_torch.models import loftr
    from detectorfreesfm_tpu_torch.parallel.orchestrate import (
        run_eval_scenes)
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        MatcherTrainer)

    out = os.path.join(work, f"rank{rank}")
    os.makedirs(out, exist_ok=True)

    # 1. This rank's half of the global batch, one step.
    with np.load(os.path.join(work, "batch.npz")) as f:
        half = {k: f[k][rank * 2:(rank + 1) * 2] for k in f.files}
    tt = MatcherTrainer(_small_matcher_cfg(), device="cpu")
    state = tt.init_state(half)
    state, loss = tt.train_step(state, half)
    torch.save({"loss": float(loss), "grad_norm": tt.history[-1]["grad_norm"],
                "params": state.params}, os.path.join(out, "step.pt"))

    # 2. The verb, on the group the caller made.
    cfg = loftr.MatcherConfig
    try:  # the verb's matcher at this test's size
        loftr.MatcherConfig = lambda **kw: cfg(n_coarse_layers=1, border=1,
                                               max_matches=32, **kw)
        rc = cli.main(["train-matcher", "--data", os.path.join(work, "data"),
                       "--output", os.path.join(out, "train"), "--epochs",
                       "1", "--img-resize", "64", "--samples-per-scene", "2",
                       "--log-every", "1", "--max-steps", "2", "--device",
                       "cpu", "--log-json", os.path.join(out, "log.jsonl")])
    finally:
        loftr.MatcherConfig = cfg
    assert rc == 0, rc

    # 3. Scenes strided over the ranks; rank 0 writes metrics.txt.
    run_eval_scenes(SCENES, _scene_fn, os.path.join(work, "eval"),
                    title="dp")
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    """The inputs, then both ranks, each in its own process (limit 300 s);
    returns the work dir."""
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        tuple_to_pair_batch)
    from test_torch_train import planar_tuple, write_planar_scenes

    work = str(tmp_path_factory.mktemp("dp"))
    batch = tuple_to_pair_batch([planar_tuple(v=2, size=64, seed=s)
                                 for s in range(ROWS)])
    np.savez(os.path.join(work, "batch.npz"), **batch)
    write_planar_scenes(os.path.join(work, "data"), size=64, views=2)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r), port,
         work], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return work


def test_split_batch_step_equals_whole_batch_step(group_run):
    """Each rank stepped on its 2 rows: both hold the same parameters, and
    the step equals one process's on all 4 rows (loss and gradient norm
    1e-5 relative, parameters 1e-6 absolute)."""
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        MatcherTrainer)

    got = [torch.load(os.path.join(group_run, f"rank{r}", "step.pt"))
           for r in range(WORLD)]
    with np.load(os.path.join(group_run, "batch.npz")) as f:
        batch = {k: f[k] for k in f.files}
    torch.set_num_threads(1)
    tt = MatcherTrainer(_small_matcher_cfg(), device="cpu")
    state, loss = tt.train_step(tt.init_state(batch), batch)
    for g in got:
        assert g["params"].keys() == state.params.keys()
        for k, v in got[0]["params"].items():
            assert torch.equal(g["params"][k], v), k
        np.testing.assert_allclose(g["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], tt.history[-1]["grad_norm"],
                                   rtol=1e-5)
    for k, v in state.params.items():
        np.testing.assert_allclose(got[0]["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_train_matcher_verb_under_a_group(group_run):
    """`train-matcher` under the group: both ranks log the same global
    losses and write byte-equal checkpoints, though each trained on its
    own scene index."""
    ckpts, logs = [], []
    for r in range(WORLD):
        with open(os.path.join(group_run, f"rank{r}", "train",
                               "matcher_ep0.msgpack"), "rb") as f:
            ckpts.append(f.read())
        with open(os.path.join(group_run, f"rank{r}", "log.jsonl")) as f:
            logs.append([json.loads(ln) for ln in f])
    assert len(logs[0]) == len(logs[1]) == 2
    for a, b in zip(*logs):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        assert np.isfinite(a["loss"])
    assert ckpts[0] == ckpts[1]


def test_eval_scenes_over_a_group_write_one_process_metrics(group_run,
                                                            tmp_path):
    """run_eval_scenes strided over 2 ranks writes the metrics.txt of one
    process running every scene."""
    from detectorfreesfm_tpu_torch.parallel.orchestrate import (
        run_eval_scenes)

    run_eval_scenes(SCENES, _scene_fn, str(tmp_path), title="dp",
                    process_index=0, process_count=1)
    with open(os.path.join(group_run, "eval", "metrics.txt")) as f, \
            open(tmp_path / "metrics.txt") as g:
        got, want = f.read(), g.read()
    assert "scene_4" in want and got == want


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        _worker(int(sys.argv[i + 1]), sys.argv[i + 2], sys.argv[i + 3])
    else:
        raise SystemExit(pytest.main([__file__, "-q"]))
