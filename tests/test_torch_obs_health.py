"""dpxmon of the port (``obs/metrics.py``, ``obs/health.py``,
``perfbench/stats.py``, ``serve/fleet/autoscale.py``) against the JAX
package's.

The same calls and the same records go through both packages' modules
and what comes back is compared (the JAX package's own cases in
``tests/test_obs_mon.py`` and ``tests/test_serve_fleet.py``, as parity
cases):

- the registry: counters, gauges and histograms (the bounded reservoir,
  cumulative totals), the disabled path, the type-collision error,
  providers (a crashing one skipped), ``emit_snapshot`` and the
  ``on_train_step`` cadence, ``validate_snapshot`` on each issue class;
- ``parse_rules`` on every rule kind and every malformed spec: the same
  ``Rule``s, the same error types and messages; ``DEFAULT_RULES``;
- ``HealthMonitor`` fed the same snapshot sequences (ceilings with
  hysteresis, flapping at the boundary, drift, growth, absent metrics,
  failure events and recovery, give-up, per-rank streams) gives the same
  transitions, verdicts and stream states; ``LogFollower`` buffers a
  torn line;
- ``stats.summarize`` / ``measure`` / ``measure_until`` / ``gated_ratio``
  equal on seeded trials;
- ``FleetAutoscaler`` makes the same decisions on the same metric
  sequences, and over a real port ``FleetRouter`` it adds and drains
  replicas with ``fleet_scale`` events.

Serial run time ~12 s.
"""

import dataclasses
import json

import numpy as np
import pytest

from distributed_pytorch_tpu.obs import export as jexport
from distributed_pytorch_tpu.obs import health as jhealth
from distributed_pytorch_tpu.obs import metrics as jmetrics
from distributed_pytorch_tpu.obs import trace as jtrace
from distributed_pytorch_tpu.perfbench import stats as jstats
from distributed_pytorch_tpu.serve.fleet import autoscale as jautoscale
from distributed_pytorch_tpu_torch.obs import export as pexport
from distributed_pytorch_tpu_torch.obs import health as phealth
from distributed_pytorch_tpu_torch.obs import metrics as pmetrics
from distributed_pytorch_tpu_torch.obs import trace as ptrace
from distributed_pytorch_tpu_torch.perfbench import stats as pstats
from distributed_pytorch_tpu_torch.serve.fleet import autoscale as pautoscale

MODS = {"jax": (jmetrics, jtrace, jexport, jhealth),
        "port": (pmetrics, ptrace, pexport, phealth)}


@pytest.fixture(autouse=True)
def _clean():
    for m, t, _, _ in MODS.values():
        m.reset()
        t.reset()
    yield
    for m, t, _, _ in MODS.values():
        m.reset()
        t.reset()


def _snap(rank=0, t=100.0, step=1, source="test", **m):
    return {"event": "metrics_snapshot", "time": t, "rank": rank,
            "step": step, "source": source, "metrics": m}


def _hist(p99, count=8):
    return {"count": count, "sum": p99 * count, "min": p99, "max": p99,
            "p50": p99, "p99": p99}


def _no_builtins(snap):
    """A snapshot without the process-dependent built-ins."""
    return {k: v for k, v in snap.items() if k != "proc.rss_bytes"}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _registry_calls(m):
    m.configure(enabled=True, rank=3)
    m.inc("a.count", 2)
    m.inc("a.count")
    m.set_gauge("a.gauge", 1.5)
    for v in range(10):
        m.observe("a.hist", float(v))
    h = m.histogram("b.hist")
    for v in range(1000):
        h.observe(float(v))
    m.register_provider("good", lambda: {"p.val": 7, "p.none": None})

    def boom():
        raise RuntimeError("provider crashed")

    m.register_provider("bad", boom)
    m.register_provider("gone", lambda: {"gone.val": 1})
    m.unregister_provider("gone")
    try:
        m.gauge("a.count")
        collision = None
    except TypeError as e:
        collision = str(e)
    m.configure(enabled=False)
    m.inc("x")
    m.set_gauge("y", 1.0)
    m.observe("z", 1.0)
    m.configure(enabled=True)
    return _no_builtins(m.snapshot()), len(h.recent), collision


def test_registry_equals_jax():
    got = {k: _registry_calls(mods[0]) for k, mods in MODS.items()}
    assert got["port"] == got["jax"]
    snap, recent, collision = got["port"]
    assert snap["a.count"] == 3 and snap["a.gauge"] == 1.5
    assert snap["a.hist"]["p50"] == 5.0 and snap["b.hist"]["count"] == 1000
    assert recent == pmetrics.RESERVOIR_CAP
    assert "x" not in snap and "gone.val" not in snap and collision


def test_emit_snapshot_and_train_step_cadence_equal_jax(tmp_path,
                                                        monkeypatch):
    out = {}
    for name, (m, t, ex, _) in MODS.items():
        log = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("DPX_METRICS_LOG", str(log))
        m.configure(enabled=True, every=2, rank=0)
        for _ in range(6):
            m.on_train_step("unit")
        assert m.emit_snapshot(path=str(log), step=7, source="explicit",
                               replicas=[0, 1])
        recs, bad = ex.read_log(str(log))
        assert bad == [] and ex.check_log(recs, bad) == []
        assert all(m.validate_snapshot(r) == [] for r in recs)
        out[name] = [(r["rank"], r["step"], r["source"], r.get("replicas"),
                      sorted(_no_builtins(r["metrics"])),
                      r["metrics"]["train.steps"],
                      r["metrics"]["train.step_ms"]["count"]) for r in recs]
    assert out["port"] == out["jax"]
    assert [r[1] for r in out["port"]] == [2, 4, 6, 7]
    assert out["port"][-1][5:] == (6, 5)       # gaps, not calls


def test_disabled_registry_emits_nothing(tmp_path):
    for m, *_ in MODS.values():
        m.configure(enabled=False)
        m.on_train_step("unit")
        assert not m.emit_snapshot(path=str(tmp_path / "off.jsonl"))
        assert not m.enabled()
    assert not (tmp_path / "off.jsonl").exists()


@pytest.mark.parametrize("case", ["good", "no_rank", "bad_value",
                                  "bad_hist", "no_metrics", "bool_value"])
def test_validate_snapshot_equals_jax(case):
    rec = {"good": _snap(v=1.0, h=_hist(5.0)),
           "no_rank": {k: v for k, v in _snap(v=1.0).items()
                       if k != "rank"},
           "bad_value": _snap(v="a string"),
           "bad_hist": _snap(h={"count": 1}),
           "no_metrics": {"event": "metrics_snapshot", "time": 1.0,
                          "rank": 0, "source": "t"},
           "bool_value": _snap(v=True)}[case]
    got = pmetrics.validate_snapshot(rec)
    assert got == jmetrics.validate_snapshot(rec)
    assert (got == []) == (case == "good")


# ---------------------------------------------------------------------------
# the rule grammar
# ---------------------------------------------------------------------------

GOOD_SPECS = [
    "serve.ttft_ms.p99<=500;train.steps_per_sec>=2;"
    "drift(train.steps_per_sec)@k=2.5,floor=0.2,name=slow;"
    "growth(proc.rss_bytes)@window=6,grow=0.03",
    "growth(x)@window=4", " a<=1 ; ; b>=-2.5@window=9,k=1",
    "occ<=0.9@name=pool", jhealth.DEFAULT_RULES,
]
BAD_SPECS = ["nonsense", "a<=notanum", "drift()", "a<=1@window",
             "drift(x)@window=3", "growth(x)@window=2", "a<=1@k=x",
             "drift(a b)"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_rules_equal_jax(spec):
    got = [dataclasses.asdict(r) for r in phealth.parse_rules(spec)]
    assert got == [dataclasses.asdict(r) for r in jhealth.parse_rules(spec)]
    assert got


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_rules_raise_as_jax(spec):
    errs = []
    for h in (jhealth, phealth):
        with pytest.raises(Exception) as e:
            h.parse_rules(spec)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1] and errs[0][0] is ValueError


def test_defaults_and_resolve_metric_equal_jax():
    assert phealth.DEFAULT_RULES == jhealth.DEFAULT_RULES
    assert phealth.FAILURE_RULE == jhealth.FAILURE_RULE
    assert pautoscale.DEFAULT_FLEET_RULES == jautoscale.DEFAULT_FLEET_RULES
    m = {"a": 1.0, "h": _hist(9.0), "b": True}
    for name in ("a", "h.p99", "h", "missing", "h.p12345", "b"):
        assert (phealth.resolve_metric(m, name)
                == jhealth.resolve_metric(m, name))
    assert phealth.resolve_metric(m, "h.p99") == 9.0


# ---------------------------------------------------------------------------
# the state machine
# ---------------------------------------------------------------------------

SEQUENCES = {
    "ceiling": ("occ<=0.9", dict(critical_after=3),
                [_snap(t=i, occ=0.95) for i in range(3)]
                + [_snap(t=9, occ=0.2)] * 3),
    "flapping": ("occ<=0.9", dict(critical_after=3, recover_after=2),
                 [_snap(t=i, occ=v) for i, v in enumerate(
                     (0.95, 0.5, 0.95, 0.5, 0.95, 0.5, 0.5, 0.5))]),
    "drift": ("drift(sps)@k=3,floor=0.1", {},
              [_snap(t=i, sps=100.0 + (i % 2)) for i in range(6)]
              + [_snap(t=9, sps=40.0)]),
    "jitter": ("drift(sps)@k=3,floor=0.10", {},
               [_snap(t=i, sps=float(v)) for i, v in enumerate(
                   (100, 101, 99, 100, 98, 97, 99, 96))]),
    "growth": ("growth(rss)@window=4,grow=0.02", {},
               [_snap(t=i, rss=float(v)) for i, v in enumerate(
                   (100, 110, 120, 130, 140))]),
    "growth_dip": ("growth(rss)@window=4,grow=0.02", {},
                   [_snap(t=i, rss=float(v)) for i, v in enumerate(
                       (100, 110, 105, 130, 140))]),
    "absent": ("occ<=0.9", dict(recover_after=1),
               [_snap(t=1, occ=0.95)]
               + [_snap(t=i, source="other", unrelated=1.0)
                  for i in range(2, 6)]),
    "hist": ("serve.ttft_ms.p99<=500", {},
             [_snap(t=1, **{"serve.ttft_ms": _hist(900.0)}),
              _snap(t=2, **{"serve.ttft_ms": _hist(100.0)}),
              _snap(t=3, **{"serve.ttft_ms": _hist(100.0)})]),
    "failure_recovers": ("", dict(recover_after=2),
                         [{"event": "worker_failure", "rank": 1,
                           "time": 1.0, "exitcode": 9},
                          {"event": "elastic_worker_exit", "time": 1.5,
                           "exitcode": 43},
                          _snap(rank=1, t=2.0, steps=1),
                          _snap(rank=1, t=3.0, steps=2)]),
    "failures_only": ("", {}, [{"event": "worker_failure", "rank": 2,
                                "time": 1.0}]),
    "giveup": ("", {}, [{"event": "elastic_giveup", "time": 1.0}]),
    "replica_back": ("", dict(recover_after=1),
                     [{"event": "replica_failed", "rank": 1, "time": 1.0},
                      dict(_snap(t=2.0), replicas=[0, 1])]),
    "per_rank": ("occ<=0.9", dict(recover_after=1),
                 [_snap(rank=0, t=1, occ=0.95), _snap(rank=1, t=2, occ=0.5)]),
    "defaults": (None, {},
                 [_snap(t=i, **{"train.steps_per_sec": 10.0,
                                "proc.rss_bytes": 1e9 + i * 1e8,
                                "serve.pool_occupancy": 0.5})
                  for i in range(10)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_health_monitor_equals_jax(name, tmp_path):
    spec, kw, recs = SEQUENCES[name]
    out = {}
    for pkg, (_, _, ex, h) in MODS.items():
        log = tmp_path / f"{pkg}.jsonl"
        rules = None if spec is None else h.parse_rules(spec)
        mon = h.HealthMonitor(rules, emit_path=str(log), **kw)
        trs = [mon.feed(json.loads(json.dumps(r))) for r in recs]
        emitted = []
        if log.exists():
            got, bad = ex.read_log(str(log))
            assert ex.check_log(got, bad) == []
            emitted = [{k: v for k, v in r.items()
                        if k not in ("time", "_line")} for r in got]
        out[pkg] = (trs, mon.verdict(), mon.stream_states(),
                    mon.snapshots_seen, emitted)
    assert out["port"] == out["jax"]


def test_scan_records_and_log_follower(tmp_path):
    log = tmp_path / "f.jsonl"
    mon = phealth.HealthMonitor(phealth.parse_rules("occ<=0.9"))
    f = phealth.LogFollower(str(log), mon)
    assert f.poll() == []              # a missing file is no error
    line1 = json.dumps(_snap(t=1, occ=0.95)) + "\n"
    line2 = json.dumps(_snap(t=2, occ=0.95))
    with open(log, "w") as fh:
        fh.write(line1 + line2[:10])   # a torn second line
    assert [t["to"] for t in f.poll()] == ["degraded"]
    assert mon.snapshots_seen == 1     # the torn line stays buffered
    with open(log, "a") as fh:
        fh.write(line2[10:] + "\n")
    f.poll()
    assert mon.snapshots_seen == 2
    recs = [_snap(t=i, occ=0.95) for i in range(4)]
    got = phealth.scan_records(recs, phealth.HealthMonitor(
        phealth.parse_rules("occ<=0.9"))).verdict()
    assert got == jhealth.scan_records(recs, jhealth.HealthMonitor(
        jhealth.parse_rules("occ<=0.9"))).verdict()
    assert got["state"] == "critical"


# ---------------------------------------------------------------------------
# trial statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_stats_equal_jax(seed):
    rng = np.random.default_rng(seed)
    runs = list(rng.lognormal(0.0, 0.3 * seed, size=3 + 2 * seed))
    for warmup in (0, 1, 2):
        for gate in (0.05, 0.15, float("inf")):
            a = pstats.summarize(runs, warmup=warmup, max_spread=gate)
            b = jstats.summarize(runs, warmup=warmup, max_spread=gate)
            assert a.to_dict(6) == b.to_dict(6)
            assert a.untrusted_reason == b.untrusted_reason
            assert (pstats.gated_ratio(2.0, a)
                    == jstats.gated_ratio(2.0, b))
            c = pstats.summarize(runs[::-1], warmup=warmup,
                                 max_spread=gate)
            d = jstats.summarize(runs[::-1], warmup=warmup,
                                 max_spread=gate)
            assert pstats.gated_ratio(a, c) == jstats.gated_ratio(b, d)
    assert pstats.gated_ratio(None, a) == jstats.gated_ratio(None, b)


def test_measure_and_measure_until_equal_jax():
    def thunks():
        seq = iter([5.0, 1.0, 9.0, 1.0, 1.01, 0.99, 1.0, 1.0, 1.0, 1.0])
        return lambda: next(seq)
    for mod in (pstats, jstats):
        with pytest.raises(ValueError):
            mod.measure(lambda: 1.0, trials=0)
    a = pstats.measure(thunks(), trials=4, warmup=1, max_spread=0.15)
    b = jstats.measure(thunks(), trials=4, warmup=1, max_spread=0.15)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    a = pstats.measure_until(thunks(), trials=3, warmup=1,
                             max_spread=0.05, budget_s=60.0)
    b = jstats.measure_until(thunks(), trials=3, warmup=1,
                             max_spread=0.05, budget_s=60.0)
    assert dataclasses.asdict(a) == dataclasses.asdict(b) and a.trusted
    assert a.runs == (1.0, 1.01, 0.99)


# ---------------------------------------------------------------------------
# the fleet autoscaler
# ---------------------------------------------------------------------------

class _Router:
    """A fleet double: the admitting set and the add / drain calls the
    autoscaler makes."""

    def __init__(self, n):
        self.live = list(range(n))
        self.calls = []

    def _admitting(self):
        return list(self.live)

    def add_replica(self, *, rule="", reason="scale_out"):
        rid = max(self.live, default=-1) + 1
        self.live.append(rid)
        self.calls.append(("add", rid, rule, reason))
        return rid

    def drain_replica(self, rid, *, rule="", reason="drain"):
        self.live.remove(rid)
        self.calls.append(("drain", rid, rule, reason))
        return True


BAD = {"serve.ttft_ms": {"p99": 4000.0}, "fleet.max_queue_depth": 2.0}
GOOD = {"serve.ttft_ms": {"p99": 20.0}, "fleet.max_queue_depth": 1.0}
DEEP = {"serve.ttft_ms": {"p99": 20.0}, "fleet.max_queue_depth": 40.0}


@pytest.mark.parametrize("name,n0,cfg,seq", [
    ("add_then_drain", 1, dict(min_replicas=1, max_replicas=2,
                               rules="serve.ttft_ms.p99<=500",
                               drain_after_ok=3),
     [BAD, BAD] + [GOOD] * 8),
    ("default_rules_queue", 2, dict(min_replicas=1, max_replicas=4,
                                    drain_after_ok=2),
     [DEEP, DEEP, GOOD, GOOD, GOOD, GOOD, GOOD, GOOD, GOOD]),
    ("floor_holds", 2, dict(min_replicas=2, max_replicas=3,
                            drain_after_ok=1), [GOOD] * 4),
    ("recover_hysteresis", 1, dict(min_replicas=1, max_replicas=3,
                                   rules="serve.ttft_ms.p99<=500",
                                   drain_after_ok=2, recover_after=3),
     [BAD, GOOD, BAD, GOOD, GOOD, GOOD, GOOD, GOOD, GOOD]),
])
def test_autoscaler_decisions_equal_jax(name, n0, cfg, seq):
    out = {}
    for pkg, mod in (("jax", jautoscale), ("port", pautoscale)):
        router = _Router(n0)
        scaler = mod.FleetAutoscaler(router, mod.AutoscaleConfig(**cfg))
        decisions = [scaler.step(dict(m)) for m in seq]
        out[pkg] = (decisions, router.calls, scaler.decisions,
                    scaler.monitor.verdict())
    assert out["port"] == out["jax"]
    assert any(d is not None for d in out["port"][0]) or name == "floor_holds"


def test_autoscaler_bounds_and_env_defaults(monkeypatch):
    with pytest.raises(ValueError, match="bounds"):
        pautoscale.FleetAutoscaler(_Router(1), pautoscale.AutoscaleConfig(
            min_replicas=3, max_replicas=2))
    monkeypatch.setenv("DPX_FLEET_MAX_REPLICAS", "6")
    monkeypatch.setenv("DPX_FLEET_DRAIN_AFTER_OK", "5")
    a = pautoscale.FleetAutoscaler(_Router(1))
    b = jautoscale.FleetAutoscaler(_Router(1))
    assert (a.min_replicas, a.max_replicas, a.drain_after_ok,
            a.rules_spec) == (b.min_replicas, b.max_replicas,
                              b.drain_after_ok, b.rules_spec) == (
        1, 6, 5, pautoscale.DEFAULT_FLEET_RULES)


def test_autoscaler_over_a_port_fleet(tmp_path):
    """Over a real port ``FleetRouter`` (engines never started: the
    policy is under test): a TTFT breach adds a replica, a sustained-ok
    streak drains it, each a ``fleet_scale`` event."""
    from distributed_pytorch_tpu_torch import TransformerLM
    from distributed_pytorch_tpu_torch.serve import EngineConfig
    from distributed_pytorch_tpu_torch.serve.fleet import (FleetConfig,
                                                           FleetRouter)
    from distributed_pytorch_tpu_torch.utils.logging import MetricsLogger
    model = TransformerLM(vocab=61, dim=32, n_layers=1, n_heads=4,
                          max_seq=64, device="cpu")
    log = tmp_path / "fleet.jsonl"
    fleet = FleetRouter(model, FleetConfig(
        n_replicas=1, metrics=MetricsLogger(str(log)),
        engine=EngineConfig(n_slots=1, max_len=64)))
    scaler = pautoscale.FleetAutoscaler(fleet, pautoscale.AutoscaleConfig(
        min_replicas=1, max_replicas=2, rules="serve.ttft_ms.p99<=500",
        drain_after_ok=3))
    assert scaler.step(BAD) == {"action": "add", "replica": 1,
                                "rule": "serve.ttft_ms.p99<=500",
                                "state": phealth.DEGRADED}
    assert scaler.step(BAD) is None       # at the ceiling
    drains = [d for d in (scaler.step(GOOD) for _ in range(8)) if d]
    assert drains == [{"action": "drain", "replica": 1,
                       "rule": "sustained_ok", "state": phealth.OK}]
    assert fleet._admitting() == [0]
    recs, bad = pexport.read_log(str(log))
    assert pexport.check_log(recs, bad) == []
    assert [r["action"] for r in recs if r["event"] == "fleet_scale"] == [
        "add", "drain"]
    snaps = [r for r in recs if r["event"] == "metrics_snapshot"]
    assert snaps and all(pmetrics.validate_snapshot(r) == [] for r in snaps)
