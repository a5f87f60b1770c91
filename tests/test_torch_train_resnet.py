"""The port's ``examples/train_resnet.py`` against the JAX package's.

Both examples run with the same flags, ``--limit-steps 2 --data-size 32
--batch-size 4 --eval --ema 0.9`` (2 epochs, so 4 steps), from the same
weights (the JAX example's ``PRNGKey(0)`` init, converted), at world 1
and at world 2 (the port over gloo in two spawned CPU ranks, the JAX
example on a 2-device mesh). Both add ``--lr 0.001``: at the default
lr 0.05 momentum grows float32 rounding of this model's ill-conditioned
gradients (``tests/test_torch_resnet.py``) to 1.3e-2 of the fourth
loss, the first loss being equal. Limits: every loss rtol 1e-4 (seen
3.2e-5), the eval accuracies (raw and EMA weights) equal. Also the
CIFAR-10 reader: a missing directory raises, and a fake pickle
directory reads as the JAX reader reads it. Serial run time ~45 s.
"""

import importlib
import pickle

import jax
import numpy as np
import pytest
import torch

import distributed_pytorch_tpu as jdist
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu_torch.examples import train_resnet

jex = importlib.import_module("examples.train_resnet")

ARGS = ["--lr", "0.001", "--limit-steps", "2", "--data-size", "32",
        "--batch-size", "4", "--eval", "--ema", "0.9"]


def _jax_init():
    params, _ = jax.jit(jmodels.ResNet18(n_classes=10, small_input=True).init)(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_run(world, monkeypatch):
    """The JAX example's losses (the mean over ranks per step) and the
    eval accuracies it logs."""
    monkeypatch.setenv("DPX_CPU_DEVICES", "8")
    logged = []
    orig = jex.MetricsLogger.log
    monkeypatch.setattr(jex.MetricsLogger, "log", lambda self, step, **m: (
        logged.append(m), orig(self, step, **m)))
    hist = []
    jex.main_worker(0, world, ARGS, quiet=True, history=hist)
    evals = {k: [float(m[k]) for m in logged if k in m]
             for k in ("eval_acc", "ema_eval_acc")}
    return hist, evals


def _check(rec, hist, evals):
    assert len(rec["losses"]) == len(hist) == 4
    np.testing.assert_allclose(rec["losses"], hist, rtol=1e-4)
    assert rec["eval_acc"] == evals["eval_acc"]
    assert rec["ema_eval_acc"] == evals["ema_eval_acc"]
    assert len(rec["eval_acc"]) == 2


def test_world1_matches_jax_example(monkeypatch):
    hist, evals = _jax_run(1, monkeypatch)
    rec = train_resnet.main_worker(0, 1, ARGS + ["--device", "cpu"],
                                   quiet=True, init_params=_jax_init())
    _check(rec, hist, evals)


def test_world2_gloo_matches_jax_example(monkeypatch, tmp_path):
    hist, evals = _jax_run(2, monkeypatch)
    jdist.cleanup()
    launch_cpu_ranks(train_resnet.main_worker, 2, ARGS + ["--device", "cpu"],
                     True, None, str(tmp_path), _jax_init())
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for rec in ranks:
        _check(rec, hist, evals)
    # each rank's own BatchNorm stats: they differ between the ranks
    assert not np.allclose(ranks[0]["state"]["bn_stem"]["mean"],
                           ranks[1]["state"]["bn_stem"]["mean"])


def test_log_writes_one_line_per_step_on_the_primary(tmp_path):
    log = tmp_path / "metrics.jsonl"
    train_resnet.main_worker(0, 1, ARGS + ["--device", "cpu", "--epochs",
                                           "1", "--log", str(log)],
                             quiet=True)
    lines = log.read_text().splitlines()
    assert len(lines) == 2 + 2          # 2 steps, eval raw and EMA


def test_missing_cifar_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        train_resnet.Cifar10(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        train_resnet.main_worker(0, 1, ["--device", "cpu", "--data-dir",
                                        str(tmp_path)], quiet=True)


def test_cifar10_reader_matches_jax(tmp_path):
    """The pickle-batch reader against a fake CIFAR-layout directory."""
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rng.integers(0, 256, (20, 3072), dtype=np.uint8)
        with open(d / name, "wb") as f:
            pickle.dump({b"data": data,
                         b"labels": list(rng.integers(0, 10, 20))}, f)
    for split in ("train", "test"):
        got = train_resnet.Cifar10(str(tmp_path), split=split)
        want = jex.Cifar10(str(tmp_path), split=split)
        assert len(got) == len(want) == (100 if split == "train" else 20)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        x, y = got[0]
        assert x.shape == (32, 32, 3) and x.dtype == np.float32
    rec = train_resnet.main_worker(
        0, 1, ["--device", "cpu", "--data-dir", str(tmp_path), "--epochs",
               "1", "--limit-steps", "1", "--batch-size", "4", "--eval"],
        quiet=True)
    assert len(rec["losses"]) == 1 and np.isfinite(rec["losses"]).all()
    assert len(rec["eval_acc"]) == 1
