"""Span export, the log validator and straggler detection of the port
(``obs/export.py``, ``obs/detect.py``) against the JAX package's, and a
traced port run read by the JAX package's CLIs.

- ``KNOWN_EVENTS`` / ``FAILURE_EVENTS`` are the JAX package's sets.
  ``chrome_trace``, ``collect_spans``, ``estimate_offsets``,
  ``check_log``, ``summarize_ops`` and ``stragglers`` fed the same
  records (seeded span sets: a skewed rank's barriers, a straggling
  rank, uniform ranks, one or two ranks, one or two observations per
  rank, flight-recorder copies of live spans, damaged records, a log
  with every issue class) return what the JAX package's return.
- One launch of two rank processes over the native host group
  (``_torch_obs_workers.traced_host_door_worker``: a one-layer LM through
  ``make_train_step``'s host door, 3 steps, ``DPX_TRACE=1``,
  ``DPX_MON_EVERY=1``, one shared ``DPX_METRICS_LOG``): each rank's
  steps are ``host_step`` spans with one ``backward``, one ``bucket``
  holding one ``comm:allreduce_sum`` (the JAX package's op name), and
  one ``update``; the merged log
  passes the port's ``check_log``, every snapshot passes
  ``validate_snapshot`` with its rank, the Chrome trace parses with pid
  = rank, the offsets cover both ranks, two ranks flag no straggler,
  and ``HealthMonitor`` under ``DEFAULT_RULES`` ends ``ok``. The JAX
  package's ``tools/dpxtrace.py check`` and ``tools/dpxmon.py check``
  (subprocesses) pass the port's log unchanged.

Serial run time ~24 s.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_obs_workers as ow
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu.obs import detect as jdetect
from distributed_pytorch_tpu.obs import export as jexport
from distributed_pytorch_tpu_torch.obs import detect as pdetect
from distributed_pytorch_tpu_torch.obs import export as pexport
from distributed_pytorch_tpu_torch.obs import health as phealth
from distributed_pytorch_tpu_torch.obs import metrics as pmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk_span(name, rank, t0, dur_s, span_id, **attrs):
    rec = {"event": "trace_span", "name": name, "trace_id": None,
           "span_id": span_id, "parent_id": None, "t0_wall": t0,
           "dur_ns": int(dur_s * 1e9), "rank": rank, "pid": 1000 + rank,
           "tid": "MainThread"}
    if attrs:
        rec["attrs"] = attrs
    return rec


def _ranks(medians, n=8, name="comm:allreduce", seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for rank, med in medians.items():
        for i in range(n):
            recs.append(_mk_span(name, rank, 100.0 + i + rng.random() * 1e-3,
                                 med * (1 + 0.01 * (i % 3)),
                                 f"{rank}.{name}.{i}", bytes=64))
    return recs


def _skewed_barriers():
    recs = []
    for k in range(3):
        base = 100.0 + k
        recs.append(_mk_span("comm:barrier", 0, base, 0.010, f"0.b{k}"))
        recs.append(_mk_span("comm:barrier", 1, base + 5.0, 0.010, f"1.b{k}"))
        recs.append(_mk_span("comm:allreduce", 1, base + 5.2, 0.003,
                             f"1.a{k}"))
        recs.append(_mk_span("comm:allreduce", 0, base + 0.2, 0.003,
                             f"0.a{k}"))
    return recs


def _with_flight_dump():
    recs = _ranks({0: 0.01, 3: 0.02}, n=3)
    dump = {"event": "flight_recorder", "rank": 3, "reason": "CommTimeout",
            "spans": [dict(r) for r in recs if r["rank"] == 3]
            + [_mk_span("comm:allreduce", 3, 200.0, 0.5, "3.only")]}
    damaged = dict(recs[0], span_id="dmg", dur_ns="?")
    instant = dict(_mk_span("fault_injected", 0, 150.0, 0.0, "0.i"), ph="i")
    instant["events"] = [{"name": "ckpt.d2h", "t_wall": 150.0, "step": 2}]
    return recs + [dump, damaged, instant, {"event": "ckpt_save"}]


RECORD_SETS = {
    "skewed_barriers": _skewed_barriers(),
    "straggler": _ranks({0: 0.010, 1: 0.0101, 2: 0.0099, 3: 0.040}),
    "uniform": _ranks({0: 0.010, 1: 0.0101, 2: 0.0099, 3: 0.0102}),
    "one_rank": _ranks({0: 0.010}),
    "two_ranks_far_apart": _ranks({0: 0.010, 1: 1.0}, n=4),
    "three_ranks": _ranks({0: 0.010, 1: 0.0101, 2: 0.9}, n=4),
    "one_observation": _ranks({0: 0.010, 1: 0.010, 2: 0.011, 3: 0.080},
                              n=1),
    "two_observations": _ranks({0: 0.010, 1: 0.010, 2: 0.050}, n=2),
    "flight_dump": _with_flight_dump(),
}


def test_vocabulary_equals_jax():
    assert pexport.KNOWN_EVENTS == jexport.KNOWN_EVENTS
    assert pexport.FAILURE_EVENTS == jexport.FAILURE_EVENTS
    assert (pdetect.IQR_K, pdetect.REL_FLOOR) == (jdetect.IQR_K,
                                                  jdetect.REL_FLOOR)


@pytest.mark.parametrize("name", sorted(RECORD_SETS))
def test_export_and_detect_equal_jax(name):
    recs = RECORD_SETS[name]
    spans = pexport.collect_spans([dict(r) for r in recs])
    assert spans == jexport.collect_spans([dict(r) for r in recs])
    assert pexport.estimate_offsets(spans) == jexport.estimate_offsets(spans)
    for align in (True, False):
        got = pexport.chrome_trace([dict(r) for r in recs], align=align)
        assert got == jexport.chrome_trace([dict(r) for r in recs],
                                           align=align)
        json.loads(json.dumps(got))
    assert pdetect.op_durations(spans) == jdetect.op_durations(spans)
    assert pdetect.summarize_ops(spans) == jdetect.summarize_ops(spans)
    for k in (None, 1.5):
        assert (pdetect.stragglers(spans, k=k)
                == jdetect.stragglers(spans, k=k))
    found = [f["rank"] for f in pdetect.stragglers(spans)]
    want = {"straggler": [3], "three_ranks": [2], "one_observation": [3],
            "two_observations": [2]}.get(name, [])
    assert found == want
    if name == "skewed_barriers":
        assert pexport.estimate_offsets(spans)[1] == pytest.approx(5.0)


def test_check_log_equals_jax(tmp_path):
    log = tmp_path / "bad.jsonl"
    lines = [json.dumps({"event": "worker_failure", "rank": 1, "time": 1.0}),
             "{not json", "[1, 2]",
             json.dumps({"event": "totally_unknown", "time": 1.0}),
             json.dumps({"event": "worker_failure", "time": 2.0}),
             json.dumps({"step": 3, "time": 3.0, "loss": 0.5}),
             json.dumps({"neither": True}), "",
             json.dumps({"event": "flight_recorder", "rank": None})]
    log.write_text("\n".join(lines) + "\n")
    got = pexport.read_log(str(log))
    assert got == jexport.read_log(str(log))
    issues = pexport.check_log(*got)
    assert issues == jexport.check_log(*got)
    assert {ln for ln, _ in issues} == {2, 3, 4, 5, 7, 9}


# -- a traced run of the port's host door -------------------------------------

@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs_traced")
    log = out / "metrics.jsonl"
    with pytest.MonkeyPatch.context() as mp:
        # the rank processes inherit the knobs
        for k, v in {"DPX_TRACE": "1", "DPX_METRICS_LOG": str(log),
                     "DPX_MON_EVERY": "1", "DPX_MON": "1"}.items():
            mp.setenv(k, v)
        launch_cpu_ranks(ow.traced_host_door_worker, 2, str(out),
                         backend="host")
    recs, bad = pexport.read_log(str(log))
    return {"log": log, "recs": recs, "bad": bad,
            "losses": np.load(out / "losses.npy")}


def test_traced_host_door_spans(traced_run):
    recs = traced_run["recs"]
    spans = [r for r in recs if r.get("event") == "trace_span"]
    by_id = {s["span_id"]: s for s in spans}
    assert np.all(np.isfinite(traced_run["losses"]))
    for rank in (0, 1):
        mine = [s for s in spans if s["rank"] == rank]
        steps = [s for s in mine if s["name"] == "host_step"]
        assert len(steps) == ow.STEPS
        for st in steps:
            kids = sorted(s["name"] for s in mine
                          if s["parent_id"] == st["span_id"])
            assert kids == ["backward", "bucket", "update"]
            (bucket,) = [s for s in mine if s["parent_id"] == st["span_id"]
                         and s["name"] == "bucket"]
            comm = [s["name"] for s in mine
                    if s["parent_id"] == bucket["span_id"]]
            assert comm == ["comm:allreduce_sum"]
            assert st["attrs"] == {"wire": "mean", "buckets": 1}
        for s in mine:
            if s["parent_id"] is not None:
                parent = by_id[s["parent_id"]]
                assert parent["t0_wall"] <= s["t0_wall"] + 1e-6


def test_traced_log_is_clean_and_healthy(traced_run):
    recs, bad = traced_run["recs"], traced_run["bad"]
    assert pexport.check_log(recs, bad) == []
    snaps = [r for r in recs if r.get("event") == "metrics_snapshot"]
    assert {s["rank"] for s in snaps} == {0, 1}
    assert all(pmetrics.validate_snapshot(s) == [] for s in snaps)
    last = {s["rank"]: s["metrics"] for s in snaps}
    for m in last.values():
        assert m["train.steps"] == ow.STEPS
        assert m["comm.allreduce_sum.calls"] >= ow.STEPS
        assert m["obs.spans_recorded"] > 0
    ct = json.loads(json.dumps(pexport.chrome_trace(recs)))
    assert {e["pid"] for e in ct["traceEvents"] if e["ph"] == "X"} == {0, 1}
    spans = pexport.collect_spans(recs)
    assert set(pexport.estimate_offsets(spans)) == {0, 1}
    assert pdetect.stragglers(spans) == []      # two ranks: no verdict
    mon = phealth.scan_records(recs)
    assert mon.state == phealth.OK and mon.snapshots_seen == len(snaps)


@pytest.mark.parametrize("tool", ["dpxtrace", "dpxmon"])
def test_jax_tools_check_the_port_log(traced_run, tool):
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", f"{tool}.py"),
         "check", str(traced_run["log"])],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
