"""The port's chaos campaigns and transient-fault retry
(``runtime/chaos.py``) against the JAX package's.

- The campaigns of the JAX package's grammar tests (inline JSON, a JSON
  file, the compact form, grid expansion, every malformed one) parse to
  equal clauses in both packages, with equal ``ValueError`` texts;
  ``load_campaign`` reads ``DPX_CHAOS`` over a default in both.
- ``clause_green`` and ``campaign_verdict`` agree on the same rows.
- ``call_with_retry``: the doubling backoff with one ``comm_retry``
  event per retry, exhaustion as ``CommRetryExhausted`` with the attempt
  count, non-transient errors passing through, the budget from
  ``DPX_RETRY_MAX``; the same calls through both packages give the same
  sleeps, events and errors.
- The flaky in-process transport: ``flaky@op=handoff_send,count=2`` is
  absorbed with 2 ``comm_retry`` events, a larger count exhausts typed.
- The elastic gauges and events of a worker that dies once, through an
  in-process stand-in for the spawned child (the same sequence through
  JAX's ``elastic_run`` gives the same gauges and events).
- The repo's ``tools/dpxchaos.py report`` reads a report the port's
  ``clause_report`` rows make, green and failing.

No process is started. Serial run time ~3 s.
"""

import dataclasses
import json
import os

import pytest

from distributed_pytorch_tpu.obs import metrics as jdpxmon
from distributed_pytorch_tpu.runtime import chaos as jchaos
from distributed_pytorch_tpu.runtime import elastic as jelastic
from distributed_pytorch_tpu.runtime import faults as jfaults
from distributed_pytorch_tpu.runtime.native import \
    CommRetryExhausted as JCommRetryExhausted
from distributed_pytorch_tpu_torch.obs import metrics as dpxmon
from distributed_pytorch_tpu_torch.runtime import chaos, elastic, faults
from distributed_pytorch_tpu_torch.runtime.native import (CommError,
                                                          CommRetryExhausted)
from distributed_pytorch_tpu_torch.runtime.watchdog import WorkerFailure
from distributed_pytorch_tpu_torch.serve.disagg import LocalTransport
from tools import dpxchaos


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("DPX_FAULT", "DPX_CHAOS", "DPX_RETRY_MAX",
                 "DPX_RETRY_BACKOFF_MS"):
        monkeypatch.delenv(name, raising=False)
    for mod in (faults, jfaults):
        mod.reset()
    yield
    for mod in (faults, jfaults):
        mod.reset()


def _events(path, name):
    if not os.path.exists(path):
        return []
    recs = [json.loads(x) for x in open(path).read().splitlines()]
    return [r for r in recs if r.get("event") == name]


def _clauses(campaign):
    return (campaign.name,
            [{k: v for k, v in dataclasses.asdict(c).items() if k != "specs"}
             | {"specs": [dataclasses.asdict(s) for s in c.specs]}
             for c in campaign.clauses])


GOOD = {
    "inline_json": json.dumps({
        "name": "demo",
        "clauses": [
            {"fault": "kill@step=3,rank=1", "leg": "train_shrink",
             "expect": "elastic_resume", "id": "k"},
            {"fault": "flaky@op=handoff_send,count=2", "leg": "transport",
             "expect": "retry_recover", "env": {"DPX_RETRY_MAX": 5}}]}),
    "compact": ("transport:retry_recover:flaky@op=handoff_send,count=1;"
                "delay@op=allreduce,ms=50"),
    "grid": {"clauses": [{
        "grid": {"action": "kill", "op": ["allreduce", "barrier"],
                 "rank": [0, 1]},
        "id": "g", "leg": "train", "expect": "typed_error"}]},
    "grid_actions": {"name": "n", "clauses": [{
        "grid": {"action": ["delay", "flaky"], "op": "handoff_send",
                 "ms": [1, 2]}, "leg": "transport", "note": "x"}]},
    "list": [{"fault": "drop_conn@op=fleet_submit,call=3", "leg": "fleet"}],
}


@pytest.mark.parametrize("name", sorted(GOOD))
def test_campaigns_parse_alike(name):
    got = chaos.parse_campaign(GOOD[name])
    assert _clauses(got) == _clauses(jchaos.parse_campaign(GOOD[name]))
    assert [c.arm_env() for c in got.clauses] == \
        [c.arm_env() for c in jchaos.parse_campaign(GOOD[name]).clauses]


def test_a_campaign_file_names_itself(tmp_path):
    p = tmp_path / "storm.json"
    p.write_text(json.dumps(
        {"clauses": [{"fault": "drop_conn@op=handoff_send"}]}))
    got = chaos.parse_campaign(str(p))
    assert got.name == "storm"
    assert _clauses(got) == _clauses(jchaos.parse_campaign(str(p)))


BAD = [
    {"clauses": [{"fault": "kill@op=allredcue"}]},
    {"clauses": [{"fault": "kill@step=1", "leg": "cloud"}]},
    {"clauses": [{"fault": "kill@step=1", "expect": "magic"}]},
    {"clauses": [{"fault": "kill@step=1", "grid": {"action": "kill"}}]},
    {"clauses": [{"grid": {"op": ["allreduce"]}}]},
    {"clauses": [{"fault": "kill@step=1", "bogus": 1}]},
    {"clauses": []}, {"name": "x"}, 7, ["not an object"],
    "", "{not json", "a:b:c:kill@step=1", "cloud:typed_error:kill@step=1",
    "train:magic:kill@step=1", "missing/campaign.json"]


@pytest.mark.parametrize("bad", BAD, ids=[str(i) for i in range(len(BAD))])
def test_bad_campaigns_raise_alike(bad):
    with pytest.raises(ValueError) as got:
        chaos.parse_campaign(bad)
    with pytest.raises(ValueError) as want:
        jchaos.parse_campaign(bad)
    assert str(got.value) == str(want.value)


def test_load_campaign_reads_the_env_over_a_default(monkeypatch):
    default = {"name": "d", "clauses": [{"fault": "kill@step=1"}]}
    for mod in (chaos, jchaos):
        assert mod.load_campaign() is None
        assert mod.load_campaign(default=default).name == "d"
    monkeypatch.setenv("DPX_CHAOS", "delay@op=allreduce,ms=5")
    assert _clauses(chaos.load_campaign(default=default)) == \
        _clauses(jchaos.load_campaign(default=default))
    assert chaos.LEGS == jchaos.LEGS and chaos.EXPECTS == jchaos.EXPECTS


def _rows(mod):
    c = mod.parse_campaign({"clauses": [
        {"fault": "kill@step=1", "expect": "typed_error", "id": "t"},
        {"fault": "flaky@op=handoff_send", "leg": "transport",
         "expect": "retry_recover", "id": "r"},
        {"fault": "kill@step=2", "expect": "elastic_resume", "id": "e"}]}
    ).clauses
    t, r, e = c
    rep = mod.clause_report
    return [
        rep(t, fired=True, typed_error="CommError", attributed=True),
        rep(t, fired=False, typed_error="CommError", attributed=True),
        rep(t, fired=True, typed_error="CommError", attributed=False),
        rep(r, fired=True, recovered=True, retries=2),
        rep(r, fired=True, recovered=True, retries=0),
        rep(r, fired=True, recovered=True, retries=2,
            typed_error="CommRetryExhausted"),
        rep(e, fired=True, typed_error="WorkerFailure", attributed=True,
            recovered=True),
        rep(e, fired=True, typed_error="WorkerFailure", attributed=True,
            recovered=False, detail="no relaunch"),
        dict(rep(t, fired=True), expect="unknown")]


def test_verdicts_match_jax():
    got, want = _rows(chaos), _rows(jchaos)
    assert got == want
    assert [chaos.clause_green(r) for r in got] == \
        [jchaos.clause_green(r) for r in want] == \
        [True, False, False, True, False, False, True, False, False]
    for rows in (got, got[:1], got[3:4] + got[6:7]):
        assert chaos.campaign_verdict(rows) == jchaos.campaign_verdict(rows)
    assert chaos.campaign_verdict(got[3:4] + got[6:7])["ok"]


def _retry_trace(mod, exc_type, fn_factory, tmp_path, monkeypatch, **kw):
    log = tmp_path / f"{mod.__name__}.jsonl"
    monkeypatch.setenv("DPX_METRICS_LOG", str(log))
    sleeps = []
    try:
        out = ("ok", mod.call_with_retry(fn_factory(), op="demo", rank=3,
                                         sleep=sleeps.append, **kw))
    except Exception as e:  # noqa: BLE001 (compared across packages)
        out = (type(e).__name__, str(e), getattr(e, "attempts", None),
               getattr(e, "op", None), isinstance(e, exc_type))
    evs = [{k: v for k, v in x.items() if k != "time"}
           for x in _events(str(log), "comm_retry")]
    return out, sleeps, evs


def _flaky(n, mod):
    def factory():
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] <= n:
                raise mod.FlakyFault("boom")
            return calls["n"]
        return fn
    return factory


@pytest.mark.parametrize("case", ["recovers", "exhausts", "env_budget",
                                  "not_transient"])
def test_call_with_retry_matches_jax(case, tmp_path, monkeypatch):
    kw = {"recovers": dict(max_retries=5, backoff_ms=10.0),
          "exhausts": dict(max_retries=2, backoff_ms=0.5),
          "env_budget": {}, "not_transient": dict(max_retries=5)}[case]
    if case == "env_budget":
        monkeypatch.setenv("DPX_RETRY_MAX", "1")
        monkeypatch.setenv("DPX_RETRY_BACKOFF_MS", "3")
    n = {"recovers": 2, "exhausts": 9, "env_budget": 9}.get(case)

    def factory(mod):
        if n is None:
            def fn():
                raise KeyError("not transient")
            return lambda: fn
        return _flaky(n, mod)

    got = _retry_trace(chaos, CommRetryExhausted, factory(faults), tmp_path,
                       monkeypatch, **kw)
    want = _retry_trace(jchaos, JCommRetryExhausted, factory(jfaults),
                        tmp_path, monkeypatch, **kw)
    assert got == want
    out, sleeps, evs = got
    if case == "recovers":
        assert out == ("ok", 3) and sleeps == [0.01, 0.02]
        assert [(e["attempt"], e["backoff_ms"], e["rank"]) for e in evs] == \
            [(1, 10.0, 3), (2, 20.0, 3)]
    elif case == "exhausts":
        assert out[0] == "CommRetryExhausted" and out[2:] == (3, "demo", True)
        assert "3 attempt" in out[1] and "budget 2" in out[1]
    elif case == "env_budget":
        assert out[2] == 2 and sleeps == [0.003]
    else:
        assert out[0] == "KeyError" and sleeps == [] and evs == []
    assert issubclass(CommRetryExhausted, CommError)


def test_flaky_transport_recovers_then_exhausts(tmp_path, monkeypatch):
    log = str(tmp_path / "m.jsonl")
    monkeypatch.setenv("DPX_METRICS_LOG", log)
    monkeypatch.setenv("DPX_RETRY_BACKOFF_MS", "1")
    faults.install("flaky@op=handoff_send,count=2")
    t = LocalTransport()
    t.send(b"frame", 16)
    assert t.frames_sent == 1 and t.recv() == b"frame"
    assert faults.fired() == ["flaky@op=handoff_send,call=1",
                              "flaky@op=handoff_send,call=2"]
    evs = _events(log, "comm_retry")
    assert [(e["op"], e["attempt"]) for e in evs] == \
        [("handoff_send", 1), ("handoff_send", 2)]
    faults.reset()
    monkeypatch.setenv("DPX_RETRY_MAX", "1")
    faults.install("flaky@op=handoff_recv,count=5")
    t = LocalTransport()
    t.send(b"frame", 16)
    with pytest.raises(CommRetryExhausted) as info:
        t.recv()
    assert (info.value.attempts, info.value.op) == (2, "handoff_recv")
    faults.install("drop_conn@op=handoff_send")
    t = LocalTransport()
    with pytest.raises(Exception, match="severed"):
        t.send(b"frame", 16)
    assert t.severed and t.frames_sent == 0


class _InlineProcess:
    """A stand-in for a spawned child that runs ``target`` in this
    process, its environment restored after, and dies (exit code 3) on
    the first attempt."""

    def __init__(self, target, args):
        self._target, self._args = target, args
        self.exitcode = None

    def start(self):
        saved = dict(os.environ)
        try:
            env = self._args[2]
            self.exitcode = 3 if env["DPX_ELASTIC_ATTEMPT"] == "0" else 0
            if self.exitcode == 0:
                self._target(*self._args)
        finally:
            os.environ.clear()
            os.environ.update(saved)

    def join(self, timeout=None):
        return None

    def is_alive(self):
        return False


class _InlineCtx:
    def Process(self, target, args):
        return _InlineProcess(target, args)


def _noop():
    return None


def _elastic_trace(mod, mon, tmp_path, monkeypatch):
    log = tmp_path / f"{mod.__name__}.jsonl"
    monkeypatch.setenv("DPX_METRICS_LOG", str(log))
    monkeypatch.setattr(mod.mp, "get_context", lambda m: _InlineCtx())
    res = mod.elastic_run(_noop, max_restarts=2, backoff_s=0.0)
    gauges = (mon.gauge("elastic.attempts").value,
              mon.gauge("elastic.last_exit_code").value)
    evs = [{k: v for k, v in json.loads(x).items() if k != "time"}
           for x in log.read_text().splitlines()]
    with pytest.raises(Exception) as info:
        monkeypatch.setattr(_InlineProcess, "start", lambda self: setattr(
            self, "exitcode", 5))
        mod.elastic_run(_noop, max_restarts=1, backoff_s=0.0)
    return (tuple(res), gauges, evs, type(info.value).__name__,
            info.value.exitcode, str(info.value),
            mon.gauge("elastic.last_exit_code").value)


def test_elastic_gauges_and_events_match_jax(tmp_path, monkeypatch):
    got = _elastic_trace(elastic, dpxmon, tmp_path, monkeypatch)
    monkeypatch.undo()
    want = _elastic_trace(jelastic, jdpxmon, tmp_path, monkeypatch)
    assert got[:2] == want[:2] == ((1, (3, 0)), (2, 0))
    assert [e["event"] for e in got[2]] == \
        ["elastic_worker_exit", "elastic_recovered"]
    assert got[2] == want[2]
    assert got[3:] == want[3:]
    assert got[3] == "WorkerFailure" and got[4] == 5
    assert issubclass(WorkerFailure, RuntimeError)


def test_dpxchaos_reads_a_port_report(tmp_path, capsys):
    rows = _rows(chaos)
    rep = tmp_path / "r.json"
    rep.write_text(json.dumps({"name": "port", "clauses": [rows[3],
                                                           rows[6]]}))
    assert dpxchaos.main(["report", str(rep)]) == 0
    assert "port: 2/2 clause(s) green" in capsys.readouterr().out
    rep.write_text(json.dumps({"name": "port", "clauses": rows}))
    assert dpxchaos.main(["report", str(rep)]) == 1
    out = capsys.readouterr().out
    assert "NOT GREEN" in out and "3/9 clause(s) green" in out
