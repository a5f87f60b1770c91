"""The port's input pipeline and profiler: ``DataLoader.iter_from``,
``data/prefetch.py`` and ``utils/profiler.py`` (on the CPU; the card's
pinned-memory copy stream runs in ``chip_smoke.py``'s ``lm_trainer``).

- ``iter_from(k)`` yields exactly the batches after skipping k, and the
  rows the JAX loader's ``iter_from(k)`` yields (world 1, shuffled),
  exactly.
- Prefetched batches equal unprefetched ones, in order; ``close()``
  stops and joins the worker mid-stream; an exception in the worker is
  raised in the consumer after the batches before it.
- ``StepTimer`` / ``time_steps_amortized`` summaries; ``trace`` and
  ``start_trace``/``stop_trace`` write a Chrome trace holding the
  ``annotate`` region; ``compiled_stats`` / ``compiled_memory`` /
  ``device_memory_stats`` on the CPU; ``CommStats`` accounting.

Serial run time ~5 s.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import data as jdata
from distributed_pytorch_tpu_torch.data import (DataLoader, PrefetchLoader,
                                                SyntheticLM, device_prefetch)
from distributed_pytorch_tpu_torch.utils import profiler


def _loader(n=40, batch=4, seed=0):
    return DataLoader(SyntheticLM(n, 8, 61), batch_size=batch,
                      shuffle=True, seed=seed, drop_last=True)


@pytest.mark.parametrize("k", [0, 3, 9])
def test_iter_from_skips_at_the_index_level(k):
    loader = _loader()
    loader.set_epoch(2)
    whole = list(loader)
    assert len(whole) == 10
    got = list(loader.iter_from(k))
    assert len(got) == 10 - k
    for a, b in zip(got, whole[k:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    jl = jdata.DataLoader(jdata.SyntheticLM(40, 8, 61), batch_size=4,
                          shuffle=True, drop_last=True)
    jl.set_epoch(2)
    for a, b in zip(got, jl.iter_from(k)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y)


def test_prefetched_batches_equal_unprefetched():
    loader = _loader()
    want = list(loader)
    it = device_prefetch(loader, size=2, place="cpu")
    got = list(it)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert it.batches == len(want) and it.host_s > 0
    pl = PrefetchLoader(_loader(), size=3, place="cpu")
    assert len(pl) == 10
    pl.set_epoch(1)
    ref = _loader()
    ref.set_epoch(1)
    for a, b in zip(pl, ref):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_close_joins_the_worker():
    it = device_prefetch(_loader(n=400), size=2, place="cpu")
    first = next(it)
    assert first[0].shape == (4, 8)
    worker = it._thread
    it.close()
    assert not worker.is_alive()
    assert it._q.empty()
    with pytest.raises(StopIteration):
        next(it)


def test_worker_exception_surfaces_in_the_consumer():
    def source():
        for i in range(3):
            yield (torch.full((2,), i),)
        raise ValueError("bad shard")

    it = device_prefetch(source(), size=1, place="cpu")
    got = [next(it)[0][0].item() for _ in range(3)]
    assert got == [0, 1, 2]
    with pytest.raises(ValueError, match="bad shard"):
        next(it)
    assert not it._thread.is_alive()


def test_prefetch_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_prefetch(_loader())
    with pytest.raises(ValueError):
        device_prefetch(_loader(), size=0, place="cpu")


def test_step_timer_and_amortized_timing():
    timer = profiler.StepTimer(warmup=2)
    for _ in range(6):
        with timer.step() as h:
            time.sleep(0.002)
            h["fence"] = torch.ones(2)
    assert len(timer.warmup_times) == 2 and timer.count == 4
    s = timer.summary()
    assert set(s) == {"steps", "mean_s", "median_s", "p10_s", "p90_s",
                      "steps_per_sec"}
    assert s["steps"] == 4 and s["mean_s"] >= 0.002
    assert timer.throughput(10) == pytest.approx(10 * s["steps_per_sec"])
    m = profiler.StepTimer(warmup=1, fetch=True)
    out = m.measure(lambda x: x * 2, torch.ones(3), n=3,
                    fence_of=lambda y: y[0])
    assert torch.equal(out, torch.full((3,), 2.0))
    assert m.count == 3 and len(m.warmup_times) == 1
    assert profiler.StepTimer().summary() == {}
    sec, state = profiler.time_steps_amortized(lambda x: x + 1,
                                               torch.zeros(()), 5,
                                               fence_of=lambda x: x)
    assert state.item() == 5 and sec > 0


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    a = torch.randn(32, 32)
    with profiler.trace(str(tmp_path / "t")):
        with profiler.annotate("dpx-region"):
            (a @ a).sum()
    files = list((tmp_path / "t").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "dpx-region" for e in events)
    profiler.start_trace(str(tmp_path / "u"))
    with pytest.raises(RuntimeError, match="already"):
        profiler.start_trace(str(tmp_path / "u"))
    path = profiler.stop_trace()
    assert path.startswith(str(tmp_path / "u"))
    with pytest.raises(RuntimeError, match="no trace"):
        profiler.stop_trace()


def test_costs_of_one_call_on_the_cpu():
    a = torch.randn(16, 32)
    b = torch.randn(32, 8)
    st = profiler.compiled_stats(torch.matmul, a, b)
    assert st["ops"] >= 1 and st["kernel_launches"] == 0
    assert st["flops"] == 2 * 16 * 32 * 8
    assert profiler.compiled_memory(torch.matmul, a, b) == {} \
        or not torch.cuda.is_available()
    assert profiler.device_memory_stats("cpu") == {}


def test_comm_stats_accounting():
    cs = profiler.CommStats()
    with cs.timed("all_reduce", 1024):
        pass
    cs.record("all_reduce", 512, 0.5, hidden=True)
    cs.record("broadcast", 8, 0.25)
    snap = cs.snapshot()
    assert snap["calls"] == 3 and snap["bytes"] == 1544
    assert snap["overlapped_s"] == 0.5
    assert cs.summary()["all_reduce"]["calls"] == 2
    m = cs.monitor_metrics()
    assert m["comm.all_reduce.bytes"] == 1536 and m["comm.calls"] == 3
    cs.reset()
    assert cs.snapshot()["calls"] == 0


def test_prefetch_threads_do_not_leak():
    before = threading.active_count()
    for _ in range(3):
        it = device_prefetch(_loader(), size=2, place="cpu")
        next(it)
        it.close()
    assert threading.active_count() <= before
