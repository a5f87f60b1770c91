"""The data-parallel driver at world 4 on CPU ranks over gloo: a sound
run is correct, and each fault the cell can have, planted in every rank
(the launcher starts :data:`ddp_train.RANK_MAIN` by its module path, so
a rank entry of this module plants it there), makes it not correct."""

import time

import pytest

from portbench import harness, program
from portbench.drivers import ddp_train
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, trace=False):
    bench = harness.load_benchmark(root / "BENCHMARK.json")
    return harness.run_cell(bench, "tiny.ddp", 2 ** 31 + 9, 1.0, trace,
                            "cpu", time.perf_counter(), root=root)


def no_exchange_rank(rank, world, spec, out_dir):
    dp = program.port("parallel.data_parallel")
    dp._average_grads = lambda grads, world, group=None: None
    ddp_train.rank_main(rank, world, spec, out_dir)


def frozen_rank(rank, world, spec, out_dir):
    optim = program.port("optim")
    real = optim.adamw

    def frozen(*a, **k):
        opt = real(*a, **k)
        return optim.Optimizer(opt.init, lambda grads, state, params: state)
    optim.adamw = frozen
    ddp_train.rank_main(rank, world, spec, out_dir)


def half_batch_rank(rank, world, spec, out_dir):
    losses = program.port("ops.losses")
    real = losses.cross_entropy
    losses.cross_entropy = lambda lg, y: real(lg[:lg.shape[0] // 2],
                                              y[:y.shape[0] // 2])
    ddp_train.rank_main(rank, world, spec, out_dir)


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_at_world_4_is_correct(root, trace):
    res = _run(root, trace)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4
    if not trace:
        assert res["metrics"]["ddp_tokens_per_s"]["value"] > 0


@pytest.mark.parametrize("entry", [no_exchange_rank, frozen_rank,
                                   half_batch_rank])
def test_each_fault_is_not_correct(root, monkeypatch, entry):
    monkeypatch.setattr(ddp_train, "RANK_MAIN", entry)
    res = _run(root)
    assert not res["correct"], res["checks"]
