"""On the card only: one short run of each cell through the command, and
the control readings at a cell's own size. Skips without a CUDA device
(decided inside each test). Run there with

    python3 -m pytest -p no:cacheprovider -m requires_cuda portbench/tests
"""

import json
import subprocess
import sys

import pytest

from portbench import harness


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_benchmark()["workloads"]])
def test_a_short_run_of_each_cell_is_correct(cell):
    _need_card()
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          cell, "--seed", str(2 ** 31 + 99), "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.requires_cuda
def test_the_training_control_fails_at_the_cells_size(tmp_path):
    """The fp8 control and the half-batch fault on one seed of
    gpt2-small.train, read by ``portbench.calibrate``, against the
    cell's limits."""
    _need_card()
    path = tmp_path / "cal.json"
    out = subprocess.run([sys.executable, "-m", "portbench.calibrate",
                          "--workload", "gpt2-small.train", "--seeds", "1",
                          "--control-seeds", "1", "--out", str(path)],
                         capture_output=True, text=True, timeout=900,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    cal = json.loads(path.read_text())
    limits = harness.load_json(harness.HERE / "limits"
                               / "gpt2-small.train.json")
    assert harness.passes(harness.check(cal["program"]["1"], limits))
    for kind in ("fp8", "half_batch"):
        assert not harness.passes(harness.check(cal[kind]["1"], limits))
