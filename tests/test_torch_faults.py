"""The port's fault injection (``runtime/faults.py``) against the JAX
package's.

- Every ``DPX_FAULT`` spec of the JAX package's grammar tests, good and
  bad, parses to equal fields in both packages, with the same error
  types and messages; the op vocabularies are equal, and so is an
  extension through ``register_op``.
- The hook filters (op, rank, call, step, attempt; a rank-scoped spec
  never fires from a hook without a rank; ``delay`` repeats, ``kill`` /
  ``drop_conn`` are one-shot, ``flaky`` raises ``count`` times) run the
  same scripted hook calls in both packages with equal outcomes and
  equal ``fired()`` logs.
- World 2 over the native host group: ``kill@op=allreduce,call=1,
  rank=1`` in two rank processes (the one launch of this file): the
  survivor raises ``CommPeerDied`` naming peer 1 within 2x the
  deadline, ``WorkerFailure`` names rank 1 and op ``allreduce``, and a
  ``worker_failure`` event lands in ``DPX_METRICS_LOG``, as does the
  victim's ``fault_injected``; the ranks carried the launch's
  ``DPX_WORKER_TAG``, unregistered once it ended. Then two ranks
  as threads of this process: ``flaky@op=init,rank=1,count=2`` connects
  after 2 ``comm_retry`` events; ``drop_conn`` raises typed on both
  sides; ``diverge`` (one extra barrier) ends in a typed
  ``CommTimeout`` on the peer.

Serial run time ~15 s.
"""

import dataclasses
import json
import os
import re
import threading
import time

import numpy as np
import pytest

import _torch_fault_workers as fw
from distributed_pytorch_tpu.runtime import faults as jfaults
from distributed_pytorch_tpu_torch.runtime import faults, watchdog
from distributed_pytorch_tpu_torch.runtime.launcher import find_free_port
from distributed_pytorch_tpu_torch.runtime.multiprocess import \
    launch_multiprocess
from distributed_pytorch_tpu_torch.runtime.native import (CommError,
                                                          CommPeerDied,
                                                          CommTimeout,
                                                          HostComm)
from distributed_pytorch_tpu_torch.runtime.watchdog import WorkerFailure


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DPX_FAULT", raising=False)
    monkeypatch.delenv("DPX_ELASTIC_ATTEMPT", raising=False)
    for mod in (faults, jfaults):
        mod.reset()
    yield
    for mod in (faults, jfaults):
        mod.reset()


GOOD = ["kill@step=3,rank=1;delay@op=allreduce,ms=500;drop_conn@step=2",
        "kill@op=allreduce,call=2,attempt=0",
        "flaky@op=handoff_send,count=3",
        "diverge@op=allreduce,call=3,rank=2",
        "delay@op=serve_step,call=5,ms=400",
        "kill@op=ckpt_commit_window,call=2,attempt=0",
        "flaky@op=init,rank=1,count=2",
        "drop_conn@op=fleet_submit,call=3",
        " kill@op=hier_reduce ; ; delay@op=page_admit,ms=1 ",
        ""]
BAD = ["explode@step=1", "kill@when=3", "kill@step", "delay@op=allreduce",
       "kill@op=allredcue", "delay@op=my_custom_op,ms=5",
       "kill@op=allreduce,count=3", "kill@step=x"]


def _fields(specs):
    return [dataclasses.asdict(s) for s in specs]


@pytest.mark.parametrize("spec", GOOD)
def test_specs_parse_alike(spec):
    assert _fields(faults.parse_fault_spec(spec)) == \
        _fields(jfaults.parse_fault_spec(spec))


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_raise_alike(spec):
    with pytest.raises(ValueError) as got:
        faults.parse_fault_spec(spec)
    with pytest.raises(ValueError) as want:
        jfaults.parse_fault_spec(spec)
    assert str(got.value) == str(want.value)


def test_op_vocabulary_and_its_extension():
    assert faults.COMM_OPS == jfaults.COMM_OPS
    assert faults.registered_ops() == jfaults.registered_ops()
    assert faults.KILL_EXIT_CODE == jfaults.KILL_EXIT_CODE == 43
    for mod in (faults, jfaults):
        mod.register_op("my_custom_op")
    try:
        assert faults.registered_ops() == jfaults.registered_ops()
        assert _fields(faults.parse_fault_spec("delay@op=my_custom_op,ms=5")) \
            == _fields(jfaults.parse_fault_spec("delay@op=my_custom_op,ms=5"))
    finally:
        for mod in (faults, jfaults):
            mod._extra_ops.discard("my_custom_op")


class _FakeComm:
    def __init__(self):
        self.aborts = 0
        self.barriers = 0

    def abort(self):
        self.aborts += 1

    def barrier(self):
        self.barriers += 1


# (spec, calls): a call is (hook, arg, rank) or ("attempt", n, None)
SCRIPTS = {
    "delay_op": ("delay@op=allreduce,ms=1",
                 [("op", "allreduce", 0), ("op", "allreduce", 0)]),
    "op_and_rank": ("delay@op=allreduce,rank=1,ms=1",
                    [("op", "barrier", 1), ("op", "allreduce", 0),
                     ("op", "allreduce", None), ("op", "allreduce", 1)]),
    "call_per_op": ("delay@op=reduce,call=2,ms=1",
                    [("op", "reduce", 0), ("op", "gather", 0),
                     ("op", "reduce", 0), ("op", "reduce", 0)]),
    "step_scoped_drop": ("drop_conn@step=2",
                         [("step", 1, 0), ("step", 2, 0), ("step", 2, 0)]),
    "attempt": ("drop_conn@step=1,attempt=0",
                [("attempt", 1, None), ("step", 1, 0),
                 ("attempt", 0, None), ("step", 1, 0), ("step", 1, 0)]),
    "op_with_step": ("delay@op=allreduce,step=3,ms=1",
                     [("step", 2, 0), ("op", "allreduce", 0),
                      ("step", 3, 0), ("op", "allreduce", 0)]),
    "flaky_count": ("flaky@op=init,rank=1,count=2",
                    [("op", "init", 0)] + [("op", "init", 1)] * 3),
    "kill_other_rank": ("kill@step=3,rank=1",
                        [("step", 3, 0), ("step", 2, 1), ("step", 3, None)]),
    "rank_unknown": ("delay@op=allreduce,rank=1,ms=1",
                     [("op", "allreduce", None), ("step", 0, None)]),
    "serve_iteration": ("delay@op=serve_step,call=2,ms=1;drop_conn@step=3",
                        [("serve", 1, None), ("serve", 2, None),
                         ("serve", 3, None)]),
    "diverge_comm": ("diverge@op=barrier,call=1",
                     [("op", "barrier", 0), ("op", "barrier", 0)]),
}


def _play(mod, spec, calls, monkeypatch):
    mod.reset()
    fake = _FakeComm()
    mod.install(spec)
    mod.register_comm(fake)
    outcomes = []
    for hook, arg, rank in calls:
        if hook == "attempt":
            monkeypatch.setenv("DPX_ELASTIC_ATTEMPT", str(arg))
            continue
        try:
            if hook == "op":
                mod.on_comm_op(arg, rank=rank)
            elif hook == "step":
                mod.on_step(arg, rank=rank)
            else:
                mod.on_serve_iteration(arg, rank=rank)
            outcomes.append("ok")
        except Exception as e:  # noqa: BLE001 (compared across packages)
            outcomes.append(type(e).__name__)
    out = (outcomes, mod.fired(), fake.aborts, fake.barriers, mod.armed())
    mod.reset()
    monkeypatch.delenv("DPX_ELASTIC_ATTEMPT", raising=False)
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_hook_filters_match_jax(name, monkeypatch):
    spec, calls = SCRIPTS[name]
    got = _play(faults, spec, calls, monkeypatch)
    want = _play(jfaults, spec, calls, monkeypatch)
    assert got == want
    assert got[1] or name in ("rank_unknown", "kill_other_rank")


def test_unarmed_hooks_are_inert():
    assert not faults.armed()
    faults.on_comm_op("allreduce", rank=0)
    faults.on_step(3, rank=1)
    assert faults.fired() == [] and faults._op_calls == {}


# -- world 2 over the native host group -----------------------------------

def test_kill_mid_allreduce_is_typed_and_attributed(tmp_path, monkeypatch):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("DPX_FAULT", "kill@op=allreduce,call=1,rank=1")
    monkeypatch.setenv("DPX_COMM_TIMEOUT_MS", str(fw.TIMEOUT_MS))
    monkeypatch.setenv("DPX_METRICS_LOG", str(log))
    monkeypatch.setenv("DPX_TRACE", "1")
    with pytest.raises(WorkerFailure) as info:
        launch_multiprocess(fw.kill_worker, 2, str(tmp_path), device="cpu",
                            backend="host", timeout_s=60)
    e = info.value
    assert (e.rank, e.op, e.kind) == (1, "allreduce", "CommPeerDied")
    survivor = json.loads((tmp_path / "rank0.json").read_text())
    assert (survivor["kind"], survivor["op"], survivor["peer"]) == \
        ("CommPeerDied", "allreduce", 1)
    assert survivor["elapsed_s"] < 2 * fw.TIMEOUT_MS / 1e3
    # the launch stamped its ranks with its tag while it lived
    assert re.fullmatch(rf"{os.getpid()}-\d+", survivor["tag"])
    assert survivor["tag"] not in watchdog.active_tags()
    events = [json.loads(x) for x in log.read_text().splitlines()]
    failure = [x for x in events if x["event"] == "worker_failure"]
    assert len(failure) == 1
    assert (failure[0]["rank"], failure[0]["op"], failure[0]["world"]) == \
        (1, "allreduce", 2)
    injected = [x for x in events if x.get("event") == "fault_injected"]
    assert [(x["rank"], x["action"], x["site"]) for x in injected] == \
        [(1, "kill", "op=allreduce,call=1")]
    assert [(x["rank"], x["attrs"]["site"]) for x in events
            if x.get("name") == "fault_injected"] == \
        [(1, "op=allreduce,call=1")]
    assert [x["rank"] for x in events if x["event"] == "flight_recorder"
            and x["reason"] == "fault_kill"] == [1]


def _pair(fn0, fn1, timeout_ms=2000, linger_s=0.0):
    """``fn_r(comm)`` for ranks 0 and 1 of a fresh 2-rank host group in
    two threads of this process; each one's result or exception.
    ``timeout_ms`` is the ops' deadline (or one per rank); a rank that
    fails keeps its links open ``linger_s`` before closing them."""
    deadlines = (timeout_ms if isinstance(timeout_ms, tuple)
                 else (timeout_ms, timeout_ms))
    port = find_free_port(2)
    out = [None, None]

    def run(rank, fn):
        comm = None
        try:
            comm = HostComm("127.0.0.1", port, rank, 2, timeout_ms=5000,
                            op_timeout_ms=deadlines[rank])
            out[rank] = fn(comm)
        except BaseException as e:       # noqa: BLE001 (reported)
            out[rank] = e
            time.sleep(linger_s)
        finally:
            if comm is not None:
                comm.close()

    ts = [threading.Thread(target=run, args=(r, f), name=f"rank{r}")
          for r, f in enumerate((fn0, fn1))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    return out


def _allreduce(comm):
    return comm.allreduce(np.ones(64, np.float32)).tolist()


def test_flaky_rendezvous_recovers_after_two_retries(tmp_path, monkeypatch):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("DPX_METRICS_LOG", str(log))
    monkeypatch.setenv("DPX_RETRY_BACKOFF_MS", "1")
    faults.install("flaky@op=init,rank=1,count=2")
    r0, r1 = _pair(_allreduce, _allreduce)
    assert r0 == r1 == [2.0] * 64
    retries = [json.loads(x) for x in log.read_text().splitlines()]
    retries = [x for x in retries if x["event"] == "comm_retry"]
    assert [(x["op"], x["rank"], x["attempt"], x["error"])
            for x in retries] == [("init", 1, 1, "FlakyFault"),
                                  ("init", 1, 2, "FlakyFault")]
    # init calls are counted per process: rank 0's thread takes one
    assert len(faults.fired()) == 2
    assert all(f.startswith("flaky@op=init,call=") for f in faults.fired())


def test_drop_conn_raises_typed_on_both_sides():
    faults.install("drop_conn@op=allreduce,call=2")

    def first_then(comm):
        comm.barrier()
        return _allreduce(comm)

    # ranks' allreduce calls are counted in one process: the second call
    # (whichever thread makes it) aborts that rank's own links
    t0 = time.monotonic()
    r0, r1 = _pair(first_then, first_then)
    assert all(isinstance(r, CommError) for r in (r0, r1)), (r0, r1)
    assert any(isinstance(r, CommPeerDied) for r in (r0, r1))
    assert time.monotonic() - t0 < 2 * 2.0 + 5
    assert faults.fired() == ["drop_conn@op=allreduce,call=2"]


def test_diverge_is_a_typed_timeout_on_the_peer():
    """Rank 1 calls one barrier its peer does not: the peer's all-reduce
    ends at its deadline as a typed ``CommTimeout`` (the diverging rank's
    own deadline is longer, and it keeps its links open past the peer's);
    rank 1's barrier fails typed too."""
    faults.install("diverge@op=allreduce,rank=1")
    t0 = time.monotonic()
    r0, r1 = _pair(_allreduce, _allreduce, timeout_ms=(800, 3000),
                   linger_s=2.0)
    assert isinstance(r0, CommTimeout), r0
    assert (r0.op, r0.rank, r0.peer, r0.deadline_ms) == \
        ("allreduce", 0, 1, 800)
    assert isinstance(r1, CommError) and r1.op == "barrier", r1
    assert time.monotonic() - t0 < 10
    assert len(faults.fired()) == 1
    assert faults.fired()[0].startswith("diverge@op=allreduce,call=")


def test_every_host_op_reaches_the_hook_under_its_jax_name():
    """A world-1 host group: each collective (the sharded update's
    ``reduce_scatter`` / ``allgather`` legs among them) fires
    ``on_comm_op`` under the JAX package's op name."""
    ops = ("allreduce", "allreduce_q8", "allreduce_q4", "reduce_scatter",
           "allgather", "reduce", "gather", "broadcast", "barrier")
    faults.install(";".join(f"delay@op={op},ms=1" for op in ops))
    comm = HostComm("127.0.0.1", find_free_port(), 0, 1)
    try:
        x = np.ones(512, np.float32)
        comm.allreduce(x.copy())
        comm.allreduce_q8(x.copy())
        comm.allreduce_q4(x.copy())
        comm.reduce_scatter_q8(x.copy())
        comm.allgather_q8(x.copy())
        comm.reduce(x.copy())
        comm.gather(x)
        comm.broadcast(x.copy())
        comm.barrier()
    finally:
        comm.close()
    assert faults.fired() == [f"delay@op={op},call=1" for op in ops]
    assert set(ops) <= set(jfaults.COMM_OPS)

