"""``correct`` must come out false for the control and for every fault a
cell can have, here at the tiny size; the same readings at the cells'
own sizes come from ``portbench.calibrate`` on the card.

The control is the reference put in the program's place and computed in
fp8 (``reference.gpt2.fp8_mm``). The faults are planted in the program
under a whole run of the harness (the look for a card skipped): a step
that returns its state unchanged, half of each batch left out with the
mean taken over the rest, a served token altered where it is produced.
No cell spans chips, so the exchange between chips has no fault here.
"""

import time

import pytest
import torch

from portbench import calibrate, checks, harness, program
from portbench.drivers import serve_closed, train
from portbench.reference import gpt2 as ref
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def bench(root):
    return harness.load_benchmark(root / "BENCHMARK.json")


def _run(bench, root, cell, seed=2 ** 31 + 5):
    return harness.run_cell(bench, cell, seed, 1.0, False, "cpu",
                            time.perf_counter(), root=root)


def _pieces(bench, root, cell, seed):
    c, config, mix, limits = harness.cell_pieces(bench, cell, root)
    return harness.Run(cell=c, config=config, mix=mix, seed=seed,
                       seconds=1.0, trace=False, device="cpu",
                       t_start=time.perf_counter()), limits


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_train_control_is_not_correct(bench, root, seed):
    r, limits = _pieces(bench, root, "tiny.train", seed)
    control = train.reference_readings(r, mm=ref.fp8_mm)
    numbers = checks.train_numbers([calibrate._as_rank(control)],
                                   train.reference_readings(r))
    assert not harness.passes(harness.check(numbers, limits)), numbers


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serve_control_is_not_correct(bench, root, seed):
    r, limits = _pieces(bench, root, "tiny.serve", seed)
    out = serve_closed.run(r)
    assert harness.passes(harness.check(out.numbers, limits))
    gaps = serve_closed.served(r.config, out.context["sample"], seed,
                               torch.device("cpu"), pick_mm=ref.fp8_mm)
    numbers = checks.serve_numbers(gaps)
    assert not harness.passes(harness.check(numbers, limits)), numbers


def test_sound_runs_are_correct(bench, root):
    assert _run(bench, root, "tiny.train")["correct"]
    assert _run(bench, root, "tiny.serve")["correct"]


def test_a_step_that_returns_its_state_unchanged(bench, root, monkeypatch):
    optim = program.port("optim")
    real = optim.adamw

    def frozen(*a, **k):
        opt = real(*a, **k)
        return optim.Optimizer(opt.init, lambda grads, state, params: state)
    monkeypatch.setattr(optim, "adamw", frozen)
    res = _run(bench, root, "tiny.train")
    assert not res["correct"]
    assert res["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_of_each_batch_left_out(bench, root, monkeypatch):
    losses = program.port("ops.losses")
    real = losses.cross_entropy

    def half(logits, labels):
        n = logits.shape[0] // 2
        return real(logits[:n], labels[:n])
    monkeypatch.setattr(losses, "cross_entropy", half)
    assert not _run(bench, root, "tiny.train")["correct"]


def test_a_served_token_altered_where_it_is_produced(bench, root,
                                                     monkeypatch):
    engine = program.port("serve.engine").InferenceEngine
    real = engine._sample_for
    vocab = tiny.TINY_SERVE["vocab_size"]

    def altered(self, req, logits):
        return (real(self, req, logits) + 1) % vocab
    monkeypatch.setattr(engine, "_sample_for", altered)
    assert not _run(bench, root, "tiny.serve")["correct"]
