"""dpxtrace of the port (``obs/trace.py``) against the JAX package's.

Each scenario runs through both packages' trace modules, from the same
calls, and what they record is compared (the JAX package's own cases in
``tests/test_obs.py``, as parity cases):

- span lineage (a parent's trace id flows to its children), an exception
  annotated on its span with the ambient stack repaired, an instant
  event attached to the open span, a standalone event;
- the flight recorder: ring wraparound and its drop count,
  ``flight_dump`` once per new recording and silent on an empty ring,
  ``on_typed_failure`` lifting the typed error's attribution (the port's
  ``CommTimeout`` beside the JAX package's);
- one span's record has the JAX package's keys, in its order, and so
  has its sink line; disabled, ``span`` returns one shared no-op and
  records nothing;
- threads: a span opened on another thread never parents under the
  submitter's open span;
- ``wall_now`` is monotone and anchored, and the port's
  ``append_event`` / ``MetricsLogger`` stamps stay monotone when
  ``time.time`` steps backwards.

Serial run time ~13 s.
"""

import json
import threading
import time

import pytest

from distributed_pytorch_tpu.obs import export as jexport
from distributed_pytorch_tpu.obs import trace as jtrace
from distributed_pytorch_tpu_torch.obs import export as pexport
from distributed_pytorch_tpu_torch.obs import trace as ptrace
from distributed_pytorch_tpu_torch.utils import logging as plog

PKGS = {"jax": (jtrace, jexport), "port": (ptrace, pexport)}


@pytest.fixture(autouse=True)
def _clean():
    for tr, _ in PKGS.values():
        tr.reset()
    yield
    for tr, _ in PKGS.values():
        tr.reset()


def _enable(tr, path, ring=256):
    tr.configure(enabled=True, ring=ring, log_path=str(path))
    return path


def _both(tmp_path, scenario):
    """``scenario(trace, export, log)`` for each package; returns
    {package: result}."""
    out = {}
    for name, (tr, ex) in PKGS.items():
        log = tmp_path / f"{name}.jsonl"
        out[name] = scenario(tr, ex, log)
    return out


def _read(ex, log):
    recs, bad = ex.read_log(str(log))
    assert bad == []
    return recs


def _shape(recs):
    """The package-independent shape of span records: name, parent's
    name, trace id, attrs, event names and their attrs, in order."""
    by_id = {r["span_id"]: r["name"] for r in recs if "span_id" in r}
    return [(r["name"], by_id.get(r["parent_id"]), r["trace_id"],
             r.get("attrs"), [(e["name"], {k: v for k, v in e.items()
                                           if k not in ("name", "t_wall")})
                              for e in r.get("events", [])],
             list(r)) for r in recs]


def test_span_lineage_equals_jax(tmp_path):
    def scenario(tr, ex, log):
        _enable(tr, log)
        with tr.span("outer", trace_id="T1", a=1) as outer:
            with tr.span("inner", b="x") as inner:
                pass
            with tr.span("inner2"):
                pass
        assert inner.t1_ns <= outer.t1_ns
        recs = _read(ex, log)
        assert all(r["dur_ns"] >= 0 for r in recs)
        return _shape(recs)
    got = _both(tmp_path, scenario)
    assert got["port"] == got["jax"]
    names = [(n, parent, tid) for n, parent, tid, *_ in got["port"]]
    assert names == [("inner", "outer", "T1"), ("inner2", "outer", "T1"),
                     ("outer", None, "T1")]


def test_exception_annotated_and_stack_repaired(tmp_path):
    def scenario(tr, ex, log):
        _enable(tr, log)
        with pytest.raises(ValueError):
            with tr.span("boom"):
                raise ValueError("x")
        with tr.span("after"):
            pass
        return _shape(_read(ex, log))
    got = _both(tmp_path, scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0][3] == {"error": "ValueError"}
    assert got["port"][1][1] is None          # a root again


def test_events_attach_to_the_open_span_or_stand_alone(tmp_path):
    def scenario(tr, ex, log):
        _enable(tr, log)
        with tr.span("op"):
            tr.event("fault_injected", action="delay")
        tr.event("ckpt.d2h", trace_id="T9", step=3)
        recs = _read(ex, log)
        assert recs[1]["ph"] == "i" and recs[1]["dur_ns"] == 0
        return _shape(recs)
    got = _both(tmp_path, scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0][4] == [("fault_injected", {"action": "delay"})]
    assert got["port"][1][:4] == ("ckpt.d2h", None, "T9", {"step": 3})


def test_record_and_sink_keys_equal_jax(tmp_path):
    def scenario(tr, ex, log):
        _enable(tr, log)
        tr.set_rank(5)
        with tr.span("comm:allreduce", bytes=64, hidden=False) as s:
            s.event("retry", attempt=1)
        spans, dropped = tr.flight_snapshot()
        line = json.loads(log.read_text().splitlines()[0])
        assert line["rank"] == 5 and line["event"] == "trace_span"
        assert line["time"] == line["t0_wall"]
        sid = tr.emit_span("serve.queue", 100.0, 100.5, trace_id="T",
                           parent_id="p", request_id=3)
        emitted = json.loads(log.read_text().splitlines()[1])
        assert emitted["span_id"] == sid and emitted["dur_ns"] == 500000000
        return (list(spans[0]), list(spans[0]["events"][0]), list(line),
                dropped, list(emitted), emitted["attrs"])
    got = _both(tmp_path, scenario)
    assert got["port"] == got["jax"]


def test_disabled_span_is_one_shared_noop(tmp_path):
    def scenario(tr, ex, log):
        tr.configure(enabled=False, log_path=str(log))
        a, b = tr.span("x", a=1), tr.span("y")
        with a as inside:
            inside.event("e")
        tr.event("z")
        assert tr.emit_span("w", 1.0, 2.0) is None
        assert not log.exists()
        return (a is b, a.span_id, tr.flight_snapshot())
    got = _both(tmp_path, scenario)
    assert got["port"] == got["jax"] == (True, None, ([], 0))


def test_ring_wraparound_counts_drops(tmp_path):
    def scenario(tr, ex, log):
        _enable(tr, log, ring=4)
        for i in range(10):
            with tr.span(f"s{i}"):
                pass
        spans, dropped = tr.flight_snapshot()
        return [s["name"] for s in spans], dropped
    got = _both(tmp_path, scenario)
    assert got["port"] == got["jax"] == (["s6", "s7", "s8", "s9"], 6)


def test_flight_dump_once_per_recording_and_silent_when_empty(tmp_path):
    def scenario(tr, ex, log):
        _enable(tr, log, ring=4)
        empty = tr.flight_dump("WorkerFailure")
        for i in range(6):
            with tr.span(f"s{i}"):
                pass
        first = tr.flight_dump("CommPeerDied", op="allreduce")
        again = tr.flight_dump("CommPeerDied", op="allreduce")
        with tr.span("s6"):
            pass
        third = tr.flight_dump("CommPeerDied", op="allreduce")
        dumps = [r for r in _read(ex, log)
                 if r["event"] == "flight_recorder"]
        return (empty, first, again, third,
                [(d["reason"], d["op"], d["rank"], d["n_spans"],
                  d["dropped"], [s["name"] for s in d["spans"]], list(d))
                 for d in dumps])
    got = _both(tmp_path, scenario)
    assert got["port"] == got["jax"]
    empty, first, again, third, dumps = got["port"]
    assert (empty, first, again, third) == (False, True, False, True)
    assert dumps[0][:6] == ("CommPeerDied", "allreduce", -1, 4, 2,
                            ["s2", "s3", "s4", "s5"])


def test_on_typed_failure_lifts_attribution(tmp_path):
    from distributed_pytorch_tpu.runtime.native import \
        CommTimeout as JCommTimeout
    from distributed_pytorch_tpu_torch.runtime.native import \
        CommTimeout as PCommTimeout
    errors = {"jax": JCommTimeout, "port": PCommTimeout}

    def scenario(tr, ex, log):
        _enable(tr, log)
        with tr.span("comm:allreduce"):
            pass
        exc = errors["jax" if tr is jtrace else "port"](
            "deadline", op="allreduce", rank=2, peer=1, deadline_ms=500)
        assert tr.on_typed_failure(exc)
        (d,) = [r for r in _read(ex, log) if r["event"] == "flight_recorder"]
        return {k: v for k, v in d.items()
                if k not in ("time", "pid", "spans", "_line")}
    got = _both(tmp_path, scenario)
    assert got["port"] == got["jax"]
    assert got["port"]["reason"] == "CommTimeout"
    assert got["port"]["rank"] == 2 and got["port"]["err_peer"] == 1


def test_a_thread_parents_under_its_own_stack(tmp_path):
    """The serve engine's thread: a span it opens while the submitting
    thread holds one open is a root, never the submitter's child."""
    def scenario(tr, ex, log):
        _enable(tr, log)
        with tr.span("submitter"):
            t = threading.Thread(target=lambda: tr.span("engine")
                                 .__enter__().__exit__(None, None, None),
                                 name="engine-thread")
            t.start()
            t.join()
        recs = _read(ex, log)
        return [(r["name"], r["parent_id"] is None, r["tid"])
                for r in recs]
    got = _both(tmp_path, scenario)
    assert got["port"] == got["jax"] == [
        ("engine", True, "engine-thread"), ("submitter", True, "MainThread")]


def test_wall_now_monotone_and_anchored():
    stamps = [ptrace.wall_now() for _ in range(200)]
    assert stamps == sorted(stamps)
    assert abs(stamps[-1] - time.time()) < 60.0
    m = time.monotonic()
    assert abs(ptrace.wall_from_mono(m) - ptrace.wall_now()) < 0.1
    ns = time.perf_counter_ns()
    assert abs(ptrace.wall_from_ns(ns) - ptrace.wall_now()) < 0.1


def test_port_logging_stays_monotone_when_the_clock_steps_back(
        tmp_path, monkeypatch):
    log = tmp_path / "m.jsonl"
    monkeypatch.setenv("DPX_METRICS_LOG", str(log))
    plog.append_event("ckpt_save", step=1)
    ml = plog.MetricsLogger(str(tmp_path / "m2.jsonl"))
    ml.log(step=1, loss=1.0)
    # the system clock steps back two hours (NTP) mid-run
    monkeypatch.setattr(time, "time", lambda: 12.0)
    plog.append_event("ckpt_save", step=2)
    ml.log(step=2, loss=0.9)
    ml.event("worker_failure", rank=0)
    ml.close()
    for path in (log, tmp_path / "m2.jsonl"):
        recs = _read(pexport, path)
        times = [r["time"] for r in recs]
        assert times == sorted(times) and all(t > 1e9 for t in times)
