"""The port's training launcher, ``python -m repro_torch.launch.train``, on
the CPU at the reduced ``qwen2-0.5b`` (vocab 128).

An uninterrupted run of 6 steps checkpoints at steps 3 and 6.  A run that
died after step 3's checkpoint (a directory holding only that one) resumes
from it and ends with the uninterrupted run's parameters and optimizer
state bit for bit.  The launcher prints ``repro``'s log lines.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train as launch
from repro_torch.runtime.checkpoint import latest_step
from repro_torch.train.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--reduced", "--vocab", "128", "--steps", "6",
        "--batch", "4", "--seq", "32", "--ckpt-every", "3", "--log-every",
        "2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, capsys):
    full = launch.main(ARGS + ["--ckpt", str(tmp_path / "full")])
    out = capsys.readouterr().out
    assert "[train] arch=qwen2-0.5b-smoke params=" in out
    assert "[train] step     1 loss=" in out and "[train] done" in out
    assert [h["step"] for h in full["history"]] == [1, 2, 3, 4, 5, 6]
    losses = [h["loss"] for h in full["history"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert latest_step(str(tmp_path / "full")) == 6
    assert sorted(os.listdir(tmp_path / "full")) == [
        "LATEST", "step_000000003", "step_000000006"]

    # the run that died after step 3's checkpoint
    died = tmp_path / "died"
    died.mkdir()
    shutil.copytree(tmp_path / "full" / "step_000000003",
                    died / "step_000000003")
    (died / "LATEST").write_text("step_000000003")
    resumed = launch.main(ARGS + ["--ckpt", str(died)])
    assert "[train] resumed from step 3" in capsys.readouterr().out
    assert resumed["start"] == 3
    assert [h["step"] for h in resumed["history"]] == [4, 5, 6]
    assert [h["loss"] for h in resumed["history"]] == losses[3:]
    a, b = tree_leaves(full["state"]), tree_leaves(resumed["state"])
    assert len(a) == len(b) > 0
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert int(resumed["state"].opt.step) == 6
    assert latest_step(str(died)) == 6


def test_module_entry_point_runs(tmp_path):
    """``python -m repro_torch.launch.train`` with microbatches and
    compressed gradients."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--vocab", "64", "--steps", "2", "--batch", "4",
         "--seq", "16", "--microbatches", "2", "--compress-grads",
         "--log-every", "1"], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[train] step     2 loss=" in res.stdout
    assert res.stdout.strip().endswith("[train] done")
