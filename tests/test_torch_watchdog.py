"""The port's heartbeats, orphan cleanup and environment snapshots
(``runtime/watchdog.py``, ``runtime/env.py``) against the JAX package's.

- ``Heartbeat`` rewrites its file by an atomic rename (no ``.tmp`` left,
  ``<time> <step>`` inside); ``HeartbeatMonitor`` flags stale and silent
  ranks, not a slow starter, and reads the port's beats as the JAX
  package's monitor does.
- Two ranks as threads of this process beat once per step through
  ``faults.on_step``; ``delay@step=2,rank=1`` stalls rank 1, and the
  monitor names exactly rank 1 (``StalledWorker``) while rank 0 goes on.
- Tagged processes (``DPX_WORKER_TAG``, plain ``sleep`` subprocesses):
  ``find_tagged_workers`` / ``kill_orphan_workers`` kill the workers of
  a dead launcher, spare a live launcher's and an active tag's, and find
  the same pids as the JAX package's functions.
- ``env.snapshot`` / ``apply_overrides`` / ``restore`` /
  ``environ_copy`` / ``raw`` / ``is_set`` / ``unset`` leave the
  environment as the JAX package's do, on the same keys.

No framework launch. Serial run time ~6 s.
"""

import os
import subprocess
import sys
import threading
import time

import pytest

from distributed_pytorch_tpu.runtime import env as jenv
from distributed_pytorch_tpu.runtime import watchdog as jwatchdog
from distributed_pytorch_tpu_torch.runtime import env, faults, watchdog
from distributed_pytorch_tpu_torch.runtime.watchdog import (
    WORKER_TAG_ENV, Heartbeat, HeartbeatMonitor, StalledWorker)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DPX_FAULT", raising=False)
    faults.reset()
    yield
    faults.reset()


def test_heartbeat_is_an_atomic_stamp(tmp_path):
    d = str(tmp_path)
    hb = Heartbeat(d, rank=1)
    t0 = time.time()
    hb.beat(step=7)
    assert sorted(os.listdir(d)) == ["rank1.hb"]
    stamp, step = open(tmp_path / "rank1.hb").read().split()
    assert step == "7" and t0 <= float(stamp) <= time.time()
    jmon = jwatchdog.HeartbeatMonitor(d, world_size=2)
    mon = HeartbeatMonitor(d, world_size=2)
    assert mon.last_beats() == jmon.last_beats() == {1: float(stamp)}


def test_monitor_flags_stale_ranks_not_slow_starters(tmp_path):
    d = str(tmp_path)
    mon = HeartbeatMonitor(d, world_size=2)
    assert mon.stalled(timeout_s=60.0) == []        # slow starters
    Heartbeat(d, 0).beat()
    Heartbeat(d, 1).beat()
    mon.assert_alive(10.0)
    time.sleep(0.3)
    Heartbeat(d, 0).beat()
    assert mon.stalled(timeout_s=0.2) == [1]
    with pytest.raises(StalledWorker, match=r"\[1\]"):
        mon.assert_alive(0.2)
    assert jwatchdog.HeartbeatMonitor(d, 2).stalled(timeout_s=0.2) == [1]


def test_a_rank_stalled_by_a_fault_is_named(tmp_path):
    d = str(tmp_path)
    faults.install("delay@step=2,rank=1,ms=2500")
    stop = threading.Event()
    steps = {0: 0, 1: 0}

    def beat(rank):
        hb = Heartbeat(d, rank)
        for s in range(10_000):
            if stop.is_set():
                return
            faults.on_step(s, rank=rank)
            hb.beat(s)
            steps[rank] = s
            time.sleep(0.02)

    mon = HeartbeatMonitor(d, world_size=2)
    ts = [threading.Thread(target=beat, args=(r,), name=f"rank{r}")
          for r in (0, 1)]
    for t in ts:
        t.start()
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and mon.stalled(0.5) != [1]:
            time.sleep(0.05)
        assert mon.stalled(0.5) == [1]
        with pytest.raises(StalledWorker, match=r"\[1\]"):
            mon.assert_alive(0.5)
        assert steps[1] == 1 and steps[0] > 2
        assert faults.fired() == ["delay@step=2"]
    finally:
        stop.set()
        for t in ts:
            t.join(10)


def _sleeper(tag):
    env_ = dict(os.environ, **{WORKER_TAG_ENV: tag})
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(60)"], env=env_)
    # reaped at once when killed: a zombie would still count as alive
    threading.Thread(target=p.wait, name=f"reap-{p.pid}",
                     daemon=True).start()
    return p


def _wait_tagged(pid, tag):
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if pid in watchdog.find_tagged_workers(
                tag=tag, require_dead_launcher=False):
            return
        time.sleep(0.02)


def test_find_and_kill_tagged_workers(tmp_path):
    gone = subprocess.Popen([sys.executable, "-c", "pass"])
    gone.wait()
    live = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    dead_tag, live_tag = f"{gone.pid}-1", f"{live.pid}-2"
    active_tag = f"{gone.pid}-3"
    procs = {t: _sleeper(t) for t in (dead_tag, live_tag, active_tag)}
    try:
        for t, p in procs.items():
            _wait_tagged(p.pid, t)
        watchdog.register_active_tag(active_tag)
        jwatchdog.register_active_tag(active_tag)
        assert watchdog.active_tags() == frozenset({active_tag})
        for t in procs:
            assert watchdog.find_tagged_workers(tag=t) == \
                jwatchdog.find_tagged_workers(tag=t)
        assert watchdog.find_tagged_workers(tag=dead_tag) == \
            [procs[dead_tag].pid]
        assert watchdog.find_tagged_workers(tag=live_tag) == []
        assert watchdog.find_tagged_workers(tag=active_tag) == []
        assert watchdog.find_tagged_workers(
            tag=active_tag, exclude_active=False) == [procs[active_tag].pid]
        assert watchdog.find_tagged_workers(tag=dead_tag,
                                            exclude_tag=dead_tag) == []
        assert watchdog.kill_orphan_workers(tag=dead_tag, grace_s=5) == \
            [procs[dead_tag].pid]
        assert procs[dead_tag].wait(10) != 0
        assert watchdog.kill_orphan_workers(tag=live_tag) == []
        assert procs[live_tag].poll() is None
        live.kill()
        live.wait()
        assert watchdog.kill_orphan_workers(tag=live_tag, grace_s=5) == \
            [procs[live_tag].pid]
        watchdog.unregister_active_tag(active_tag)
        assert watchdog.kill_orphan_workers(tag=active_tag, grace_s=5) == \
            [procs[active_tag].pid]
        assert watchdog.find_tagged_workers(tag="no-such-tag") == []
    finally:
        watchdog.unregister_active_tag(active_tag)
        jwatchdog.unregister_active_tag(active_tag)
        for p in list(procs.values()) + [live]:
            if p.poll() is None:
                p.kill()
                p.wait()


KEYS = ["DPX_FAULT", "DPX_ELASTIC", "DPX_TEST_PASSTHROUGH_A",
        "DPX_TEST_PASSTHROUGH_B"]


def _env_script(mod, monkeypatch):
    monkeypatch.setenv("DPX_ELASTIC", "0")
    monkeypatch.setenv("DPX_TEST_PASSTHROUGH_B", "b")
    monkeypatch.delenv("DPX_FAULT", raising=False)
    monkeypatch.delenv("DPX_TEST_PASSTHROUGH_A", raising=False)
    saved = mod.snapshot(KEYS)
    mod.apply_overrides({"DPX_FAULT": "kill@step=1", "DPX_ELASTIC": 1,
                         "DPX_TEST_PASSTHROUGH_A": 2})
    during = {k: os.environ.get(k) for k in KEYS}
    copy = mod.environ_copy()
    copy["DPX_TEST_PASSTHROUGH_B"] = "changed"
    seen = (mod.raw("DPX_FAULT"), mod.is_set("DPX_FAULT"),
            mod.get("DPX_ELASTIC"))
    mod.unset("DPX_FAULT")
    after_unset = (mod.raw("DPX_FAULT"), mod.is_set("DPX_FAULT"))
    mod.restore(saved)
    after = {k: os.environ.get(k) for k in KEYS}
    with pytest.raises(KeyError):
        mod.raw("DPX_NOT_REGISTERED")
    return saved, during, seen, after_unset, after, \
        {k: copy.get(k) for k in KEYS}


def test_env_snapshot_restore_match_jax(monkeypatch):
    got = _env_script(env, monkeypatch)
    want = _env_script(jenv, monkeypatch)
    assert got == want
    saved, during, seen, after_unset, after, copy = got
    assert saved == {"DPX_FAULT": None, "DPX_ELASTIC": "0",
                     "DPX_TEST_PASSTHROUGH_A": None,
                     "DPX_TEST_PASSTHROUGH_B": "b"}
    assert during["DPX_TEST_PASSTHROUGH_A"] == "2"
    assert seen == ("kill@step=1", True, True)
    assert after_unset == (None, False) and after == saved
    assert copy["DPX_TEST_PASSTHROUGH_B"] == "changed"
    assert os.environ["DPX_TEST_PASSTHROUGH_B"] == "b"
