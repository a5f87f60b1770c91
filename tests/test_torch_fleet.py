"""The port's multi-replica fleet (``serve/fleet/``) against the JAX
package's, and the port's ``examples/serve_lm.py``.

- Placement: ``prefix_key``, ``rendezvous``, ``least_loaded`` and
  ``spill_order`` equal the JAX functions on seeded prompts, replica
  sets and loads; rendezvous re-homes only the keys of a removed
  replica.
- Routing (the contracts of the JAX ``tests/test_serve_fleet.py``, held
  to the port's own ``generate()``): a shared-prefix mix streams a
  single engine's and ``generate()``'s tokens with affinity hits; capacity back-pressure
  spills typed and attributed, then a full fleet rejects
  ``fleet_exhausted``; a rejection every replica would make does not
  walk the fleet; a drain while streaming finishes the stream exactly
  and re-homes the prompt; the last live replica cannot be drained; a
  kill fails only its replica's requests, typed ``ReplicaFailed``, and
  the survivors stream exactly; the fleet log's events (names and
  fields) equal the JAX fleet's on the same scenario.
- The example: ``serve_lm`` runs on the CPU plain, ``--paged`` and
  ``--disagg`` (f32 and q8), and its records carry the TTFT
  decomposition under ``--disagg``.

Serial run time ~12 s.
"""

import json
import time

import numpy as np
import pytest
import torch

from _torch_port import CPU, jax_and_port_lm
from distributed_pytorch_tpu.serve import EngineConfig as JEngineConfig
from distributed_pytorch_tpu.serve.fleet import FleetConfig as JFleetConfig
from distributed_pytorch_tpu.serve.fleet import FleetRouter as JFleetRouter
from distributed_pytorch_tpu.serve.fleet import placement as jplacement
from distributed_pytorch_tpu.utils.logging import \
    MetricsLogger as JMetricsLogger
from distributed_pytorch_tpu_torch import TransformerLM, generate
from distributed_pytorch_tpu_torch.examples import serve_lm
from distributed_pytorch_tpu_torch.serve import (AdmissionRejected,
                                                 EngineConfig, EngineStopped,
                                                 FleetConfig, FleetRouter,
                                                 InferenceEngine,
                                                 ReplicaFailed,
                                                 SamplingParams)
from distributed_pytorch_tpu_torch.serve.fleet import (REPLICA_FAILED,
                                                       REPLICA_LIVE,
                                                       REPLICA_RETIRED,
                                                       placement)
from distributed_pytorch_tpu_torch.utils.logging import MetricsLogger

MAX_LEN = 64
FLEET_EVENTS = ("fleet_route", "fleet_spill", "replica_failed",
                "replica_drained", "fleet_scale")


def _lm(**kw):
    kw = {**dict(vocab=61, dim=32, n_layers=1, n_heads=4, n_kv_heads=2,
                 pos="rope", max_seq=128), **kw}
    return TransformerLM(device=CPU, generator=torch.Generator()
                         .manual_seed(0), **kw)


def _gen(model, prompt, sp, generator=None):
    return generate(model, np.asarray(prompt)[None], sp.max_new_tokens,
                    temperature=sp.temperature, top_k=sp.top_k,
                    generator=generator, max_len=MAX_LEN)[0].numpy()


def _events(path, names=FLEET_EVENTS):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r.get("event") in names]


# ---------------------------------------------------------------------------
# placement against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_placement_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        prompt = rng.integers(0, 61, int(rng.integers(1, 40)))
        page_len = int(rng.choice([4, 8, 16]))
        key = placement.prefix_key(prompt, page_len)
        assert key == jplacement.prefix_key(prompt, page_len)
        reps = sorted(rng.choice(8, int(rng.integers(1, 6)),
                                 replace=False).tolist())
        assert placement.rendezvous(key, reps) == \
            jplacement.rendezvous(key, reps)
        loads = {r: (int(rng.integers(0, 6)), float(rng.random()))
                 for r in reps}
        skip = reps[:int(rng.integers(0, len(reps) + 1))]
        assert placement.least_loaded(loads, skip) == \
            jplacement.least_loaded(loads, skip)
        home = placement.rendezvous(key, reps)
        for q in (0, 2, 4):
            assert list(placement.spill_order(key, home, loads, q)) == \
                list(jplacement.spill_order(key, home, loads, q))


def test_rendezvous_minimal_disruption():
    keys = [placement.prefix_key(np.arange(16) + i, 16) for i in range(64)]
    before = {k: placement.rendezvous(k, [0, 1, 2]) for k in keys}
    assert len(set(before.values())) > 1
    after = {k: placement.rendezvous(k, [0, 2]) for k in keys}
    for k in keys:
        if before[k] != 1:
            assert after[k] == before[k]
        else:
            assert after[k] in (0, 2)
    with pytest.raises(ValueError):
        placement.rendezvous(keys[0], [])


def test_spill_order_prefers_home_until_backpressure():
    assert placement.spill_order(b"k", 0, {0: (0, 0.0), 1: (2, 0.0)},
                                 4)[0] == 0
    assert placement.spill_order(b"k", 1, {0: (0, 0.0), 1: (4, 0.0)},
                                 4)[0] == 0
    assert placement.spill_order(b"k", 1, {0: (4, 0.0), 1: (4, 0.0)},
                                 4)[0] == 1


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_shared_prefix_mix_exact_with_affinity(tmp_path, paged):
    """R=2 over a shared-prefix mix: every stream equals generate(),
    whichever replica served it (greedy, and sampled with a generator);
    affinity hits > 0; every route is a logged fleet_route event."""
    model = _lm()
    log = str(tmp_path / "fleet.jsonl")
    fleet = FleetRouter(model, FleetConfig(
        n_replicas=2, metrics=MetricsLogger(log),
        engine=EngineConfig(n_slots=2, max_len=MAX_LEN, paged=paged,
                            page_len=8)))
    sp = SamplingParams(max_new_tokens=8)
    prefix = np.arange(16) % 61
    prompts = [np.concatenate([prefix, [i + 1, i + 2]]) for i in range(4)]
    prompts += [(np.arange(18) + 7 * i) % 61 for i in range(3)]
    samp = SamplingParams(max_new_tokens=6, temperature=0.8, top_k=8)
    with fleet:
        handles = [fleet.submit(p, sp) for p in prompts]
        hs = fleet.submit(prompts[0], samp,
                          generator=torch.Generator().manual_seed(9))
        outs = [h.result(timeout=120) for h in handles]
        out_s = hs.result(timeout=120)
        st = fleet.stats()
    assert st["completed"] == len(prompts) + 1
    assert st["route_affinity_hit_rate"] > 0
    single = InferenceEngine(model, EngineConfig(
        n_slots=2, max_len=MAX_LEN, paged=paged, page_len=8))
    with single:
        ref = [single.submit(p, sp).result(timeout=120) for p in prompts]
    for p, out, r in zip(prompts, outs, ref):
        np.testing.assert_array_equal(out, r)
        np.testing.assert_array_equal(out, _gen(model, p, sp))
    np.testing.assert_array_equal(out_s, _gen(
        model, prompts[0], samp, torch.Generator().manual_seed(9)))
    routes = _events(log, ("fleet_route",))
    assert len(routes) == len(prompts) + 1
    assert {r["replica"] for r in routes} <= {0, 1}
    # the shared prefix homes on one replica
    assert len({r["home"] for r in routes[:4]}) == 1
    snaps = _events(log, ("metrics_snapshot",))
    assert snaps and snaps[0]["source"] == "serve_fleet"


def test_sampled_default_generator_is_the_fleet_ids():
    """Without a generator a sampled request draws from one seeded with
    its fleet id, so the replica that serves it does not matter."""
    model = _lm()
    fleet = FleetRouter(model, FleetConfig(
        n_replicas=2, engine=EngineConfig(n_slots=2, max_len=MAX_LEN)))
    sp = SamplingParams(max_new_tokens=6, temperature=0.8)
    prompts = [(np.arange(12) + 5 * i) % 61 for i in range(3)]
    with fleet:
        hs = [fleet.submit(p, sp) for p in prompts]
        outs = [h.result(timeout=120) for h in hs]
    for h, p, out in zip(hs, prompts, outs):
        np.testing.assert_array_equal(out, _gen(
            model, p, sp, torch.Generator().manual_seed(h.request_id)))


def test_spill_then_fleet_exhausted_typed(tmp_path):
    """Engines not started, so queues only fill: the home replica's
    queue_full rejection spills (typed, from/to attributed), and once
    every replica is full the next submit fails fleet_exhausted with the
    last rejection chained; started, the fleet serves the queued work."""
    model = _lm()
    log = str(tmp_path / "fleet.jsonl")
    fleet = FleetRouter(model, FleetConfig(
        n_replicas=2, metrics=MetricsLogger(log), spill_queue=99,
        engine=EngineConfig(n_slots=1, max_len=MAX_LEN, max_queue=2)))
    sp = SamplingParams(max_new_tokens=4)
    prompt = np.arange(12) % 61
    handles = [fleet.submit(prompt, sp) for _ in range(4)]
    with pytest.raises(AdmissionRejected) as ei:
        fleet.submit(prompt, sp)
    assert ei.value.reason == "fleet_exhausted"
    assert ei.value.request_id == 4
    assert isinstance(ei.value.__cause__, AdmissionRejected)
    assert ei.value.__cause__.reason == "queue_full"
    spills = _events(log, ("fleet_spill",))
    assert len(spills) == 2
    home = fleet.home_of(prompt)
    assert all(s["from_replica"] == home and s["to_replica"] != home
               for s in spills)
    assert fleet.stats()["spills"] == 2
    with fleet:
        outs = [h.result(timeout=120) for h in handles]
    for out in outs:
        np.testing.assert_array_equal(out, _gen(model, prompt, sp))


def test_proactive_spill_at_the_queue_threshold():
    model = _lm()
    fleet = FleetRouter(model, FleetConfig(
        n_replicas=2, spill_queue=1,
        engine=EngineConfig(n_slots=1, max_len=MAX_LEN)))
    prompt = np.arange(12) % 61
    first = fleet.submit(prompt, SamplingParams(max_new_tokens=2))
    second = fleet.submit(prompt, SamplingParams(max_new_tokens=2))
    assert first.replica == fleet.home_of(prompt) != second.replica
    assert fleet.stats()["spills"] == 1
    with fleet:
        for h in (first, second):
            assert len(h.result(timeout=60)) == 2


def test_deterministic_rejection_does_not_walk():
    fleet = FleetRouter(_lm(), FleetConfig(
        n_replicas=2, engine=EngineConfig(n_slots=1, max_len=MAX_LEN)))
    with pytest.raises(AdmissionRejected) as ei:
        fleet.submit(np.arange(MAX_LEN) % 61,
                     SamplingParams(max_new_tokens=8))
    assert ei.value.reason == "too_long"
    assert fleet.stats()["routes"] == 0


# ---------------------------------------------------------------------------
# drain and kill
# ---------------------------------------------------------------------------

def test_drain_while_streaming_exact_and_rehomes(tmp_path):
    model = _lm()
    log = str(tmp_path / "fleet.jsonl")
    fleet = FleetRouter(model, FleetConfig(
        n_replicas=2, metrics=MetricsLogger(log),
        engine=EngineConfig(n_slots=2, max_len=MAX_LEN)))
    sp = SamplingParams(max_new_tokens=24)
    prompt = np.arange(14) % 61
    with fleet:
        victim = fleet.home_of(prompt)
        h = fleet.submit(prompt, sp)
        while not h.tokens:
            time.sleep(0.005)
        assert fleet.drain_replica(victim, rule="sustained_ok")
        np.testing.assert_array_equal(h.result(timeout=120),
                                      _gen(model, prompt, sp))
        assert fleet.stats()["replicas"][victim]["state"] == REPLICA_RETIRED
        new_home = fleet.home_of(prompt)
        assert new_home is not None and new_home != victim
        h2 = fleet.submit(prompt, sp)
        assert h2.replica == new_home
        np.testing.assert_array_equal(h2.result(timeout=120),
                                      _gen(model, prompt, sp))
    drained = _events(log, ("replica_drained",))
    assert len(drained) == 1 and drained[0]["rank"] == victim
    assert any(r["action"] == "drain" and r["replica"] == victim
               for r in _events(log, ("fleet_scale",)))


def test_drain_last_live_replica_refused():
    fleet = FleetRouter(_lm(), FleetConfig(
        n_replicas=1, engine=EngineConfig(n_slots=1, max_len=MAX_LEN)))
    with pytest.raises(ValueError, match="last live"):
        fleet.drain_replica(0)
    assert fleet.drain_replica(5) is False


def test_kill_is_isolated_and_survivors_exact(tmp_path):
    """Killing one replica fails only its in-flight request, typed
    ReplicaFailed naming replica and request (the engine crash chained),
    and resolves it once; the stream on the survivor completes exactly;
    the shard re-homes; a revived replica (same id) serves exactly."""
    model = _lm()
    log = str(tmp_path / "fleet.jsonl")
    fleet = FleetRouter(model, FleetConfig(
        n_replicas=2, metrics=MetricsLogger(log),
        engine=EngineConfig(n_slots=2, max_len=MAX_LEN, paged=True,
                            page_len=8)))
    sp = SamplingParams(max_new_tokens=48)
    pa = np.arange(14) % 61
    with fleet:
        victim = fleet.home_of(pa)
        pb = next((np.arange(14) + s) % 61 for s in range(1, 400)
                  if fleet.home_of((np.arange(14) + s) % 61) != victim)
        ha = fleet.submit(pa, sp)
        hb = fleet.submit(pb, sp)
        while not ha.tokens:
            time.sleep(0.005)
        fleet.kill_replica(victim)
        fleet.kill_replica(victim)          # idempotent
        with pytest.raises(ReplicaFailed) as ei:
            ha.result(timeout=60)
        assert ei.value.replica == victim
        assert ei.value.request_id == ha.request_id
        assert isinstance(ei.value.__cause__, EngineStopped)
        with pytest.raises(ReplicaFailed):
            ha.result(timeout=1)
        np.testing.assert_array_equal(hb.result(timeout=120),
                                      _gen(model, pb, sp))
        assert fleet.home_of(pa) != victim
        assert fleet.stats()["replicas"][victim]["state"] == REPLICA_FAILED
        with pytest.raises(ValueError, match="not failed"):
            fleet.revive_replica(1 - victim)
        assert fleet.revive_replica(victim) == victim
        assert fleet.stats()["replicas"][victim]["state"] == REPLICA_LIVE
        h3 = fleet.submit(pa, sp)
        assert h3.replica == victim
        np.testing.assert_array_equal(h3.result(timeout=120),
                                      _gen(model, pa, sp))
        # the killed engine's pages all went back
        assert fleet._replicas[1 - victim].engine.pool.pool.live_pages() == 0
    failed = _events(log, ("replica_failed",))
    assert len(failed) == 1 and failed[0]["rank"] == victim
    assert failed[0]["inflight"] >= 1


def _scenario(fleet_cls, cfg_cls, eng_cls, logger_cls, model, params, log):
    """A fleet lifecycle with engines never started (so nothing depends on
    timing): routes and spills to exhaustion, scale out, drain the new
    replica, kill one, revive it. Returns the fleet events' (name,
    fields) without the wall clock."""
    args = (model,) if params is None else (model, params)
    fleet = fleet_cls(*args, cfg_cls(
        n_replicas=2, metrics=logger_cls(log), spill_queue=99,
        engine=eng_cls(n_slots=1, max_len=MAX_LEN, max_queue=2)))
    prompt = np.arange(12) % 61
    for i in range(4):
        fleet.submit((prompt + (i // 2)) % 61)
    with pytest.raises(Exception) as ei:
        fleet.submit(prompt)
    rid = fleet.add_replica(rule="ttft", reason="scale_out")
    assert fleet.drain_replica(rid, rule="sustained_ok")
    victim = fleet.home_of(prompt)
    fleet.kill_replica(victim, reason="test")
    fleet.revive_replica(victim)
    fleet.shutdown()
    rows = _events(log)
    return ei.value.reason, [(r.pop("event"), {k: v for k, v in r.items()
                                               if k != "time"})
                             for r in rows]


def test_fleet_log_equals_jax(tmp_path):
    jm, params, pm = jax_and_port_lm(seed=0, n_layers=1)
    got = _scenario(FleetRouter, FleetConfig, EngineConfig, MetricsLogger,
                    pm, None, str(tmp_path / "port.jsonl"))
    want = _scenario(JFleetRouter, JFleetConfig, JEngineConfig,
                     JMetricsLogger, jm, params, str(tmp_path / "jax.jsonl"))
    assert got == want
    names = [n for n, _ in got[1]]
    assert got[0] == "fleet_exhausted"
    assert set(names) == set(FLEET_EVENTS)


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--paged", "--shared-prefix", "20"],
                                   ["--disagg"],
                                   ["--disagg", "--handoff-width", "q8"]],
                         ids=["plain", "paged", "disagg", "disagg-q8"])
def test_serve_lm_example_runs_on_the_cpu(tmp_path, capsys, flags):
    log = str(tmp_path / "serve.jsonl")
    assert serve_lm.main(["--device", "cpu", "--requests", "4",
                          "--max-new", "6", "--metrics-log", log]
                         + flags) == 0
    out = capsys.readouterr().out
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    reqs = [r for r in recs if r.get("event") == "serve_request"]
    assert len(reqs) == 4 and all(r["outcome"] == "ok" for r in reqs)
    assert all(r["n_tokens"] == 6 for r in reqs)
    keys = ("prefill_ms", "handoff_ms", "decode_ms", "handoff_bytes")
    if "--disagg" in flags:
        assert "handoff B" in out and "split:" in out
        for r in reqs:
            assert all(r[k] is not None for k in keys)
            assert (r["queue_ms"] + r["prefill_ms"] + r["handoff_ms"]
                    + r["decode_ms"]) == pytest.approx(r["ttft_ms"])
    else:
        assert not any(k in r for r in reqs for k in keys)
    if "--paged" in flags:
        assert sum(r["prefix_hit_pages"] for r in reqs) > 0


def test_serve_lm_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm.main(["--requests", "1"])
