"""The PyTorch port's continuous-batching engine (serve/).

Streams: with staggered arrivals, mixed prompt lengths and mid-stream
slot reuse, every greedy stream equals the port's standalone
``generate()`` AND the JAX package's engine on the same weights; a
sampled stream with a fixed ``torch.Generator`` equals ``generate()``
with a generator in the same state. Behavior (typed rejection, priority,
deadlines, shutdown, crash, streaming, metrics) is pinned as
``tests/test_serve.py`` pins it for the JAX engine.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

from _torch_port import CPU, jax_and_port_lm
from distributed_pytorch_tpu import serve as jserve
from distributed_pytorch_tpu_torch import TransformerLM, generate
from distributed_pytorch_tpu_torch.ops.flash_attention import \
    make_flash_attn_fn
from distributed_pytorch_tpu_torch.serve import (AdmissionRejected,
                                                 EngineConfig, EngineStopped,
                                                 InferenceEngine,
                                                 RequestDeadlineExceeded,
                                                 SamplingParams, aggregate)
from distributed_pytorch_tpu_torch.utils.logging import MetricsLogger

MAX_LEN = 64


def _lm1(**kw):
    """1-layer port model for engine-behavior tests."""
    kw = {**dict(vocab=61, dim=32, n_layers=1, n_heads=4, n_kv_heads=2,
                 pos="rope", max_seq=128), **kw}
    return TransformerLM(device=CPU, generator=torch.Generator()
                         .manual_seed(0), **kw)


def _gen(model, prompt, sp, generator=None):
    return generate(model, prompt[None], sp.max_new_tokens,
                    temperature=sp.temperature, top_k=sp.top_k,
                    top_p=sp.top_p, generator=generator)[0].numpy()


def test_staggered_greedy_streams_match_generate_and_jax_engine():
    jm, params, pm = jax_and_port_lm(seed=0)
    rng = np.random.default_rng(0)
    mix = [(5, 30), (9, 3), (3, 12), (12, 6), (7, 8)]
    prompts = [rng.integers(0, 61, (s,)).astype(np.int32) for s, _ in mix]
    sps = [SamplingParams(max_new_tokens=n) for _, n in mix]
    eng = InferenceEngine(pm, EngineConfig(n_slots=3, max_len=MAX_LEN))
    with eng:
        handles = [eng.submit(prompts[i], sps[i]) for i in range(4)]
        # the second wave arrives after an early retirement freed a slot
        handles[1].result(timeout=60)
        handles.append(eng.submit(prompts[4], sps[4]))
        outs = [h.result(timeout=60) for h in handles]
    jeng = jserve.InferenceEngine(jm, params, jserve.EngineConfig(
        n_slots=3, max_len=MAX_LEN))
    with jeng:
        jouts = [jeng.submit(p, jserve.SamplingParams(max_new_tokens=n))
                 .result(timeout=120) for p, (_, n) in zip(prompts, mix)]
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, _gen(pm, prompts[i], sps[i]),
                                      err_msg=f"request {i}")
        np.testing.assert_array_equal(out, jouts[i], err_msg=f"request {i}")
    st = eng.stats()
    assert st["completed"] == 5 and st["failed"] == 0
    assert sum(st["prefill_admits"].values()) == 5
    admits = [h.metrics["admit_iteration"] for h in handles]
    retires = [h.metrics["retire_iteration"] for h in handles]
    assert admits[3] > retires[1], (admits, retires)   # slot reuse
    assert admits[3] < retires[0], (admits, retires)   # overlap


@pytest.mark.parametrize("sp", [
    SamplingParams(max_new_tokens=9, temperature=0.8, top_k=10),
    SamplingParams(max_new_tokens=9, temperature=0.9, top_p=0.9)])
def test_sampled_stream_matches_generate_with_same_generator(sp):
    _, _, pm = jax_and_port_lm(seed=1)
    prompt = np.arange(3, 10, dtype=np.int32)
    with InferenceEngine(pm, EngineConfig(n_slots=2,
                                          max_len=MAX_LEN)) as eng:
        other = eng.submit(np.arange(4, dtype=np.int32),
                           SamplingParams(max_new_tokens=12))
        out = eng.submit(prompt, sp, generator=torch.Generator()
                         .manual_seed(11)).result(timeout=60)
        other.result(timeout=60)
    ref = _gen(pm, prompt, sp, torch.Generator().manual_seed(11))
    np.testing.assert_array_equal(out, ref)


def test_flash_prefill_buckets_and_windowed_rolling_pool():
    """A flash attn_fn with a dispatch threshold inside the bucket range
    (the plain kernel version runs on the CPU above it), and a sliding
    window model whose slot rows are W wide: streams equal generate()."""
    _, _, pm = jax_and_port_lm(seed=2, port_attn_fn=make_flash_attn_fn(
        min_seq_flash=16))
    _, _, wm = jax_and_port_lm(seed=3, port_attn_fn=make_flash_attn_fn(
        window=8, min_seq_flash=None))
    rng = np.random.default_rng(2)
    for model, cases in ((pm, [(5, 6), (20, 6)]), (wm, [(4, 20), (20, 16)])):
        eng = InferenceEngine(model, EngineConfig(n_slots=2, max_len=48))
        prompts = [rng.integers(0, 61, (s,)).astype(np.int32)
                   for s, _ in cases]
        sps = [SamplingParams(max_new_tokens=n) for _, n in cases]
        with eng:
            hs = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
            outs = [h.result(timeout=60) for h in hs]
        for p, sp, out in zip(prompts, sps, outs):
            np.testing.assert_array_equal(out, _gen(model, p, sp))
    assert eng.pool.width == 8


def test_eos_truncates_stream():
    model = _lm1()
    prompt = np.arange(5, dtype=np.int32)
    ref = _gen(model, prompt, SamplingParams(max_new_tokens=10))
    eos = int(ref[4])
    with InferenceEngine(model, EngineConfig(n_slots=1,
                                             max_len=MAX_LEN)) as eng:
        out = eng.submit(prompt, SamplingParams(
            max_new_tokens=10, eos_token=eos)).result(timeout=60)
    k = int(np.argmax(ref == eos)) + 1
    np.testing.assert_array_equal(out, ref[:k])


def test_bounded_queue_typed_rejection():
    eng = InferenceEngine(_lm1(), EngineConfig(n_slots=1, max_len=MAX_LEN,
                                               max_queue=2))
    eng.submit(np.arange(4, dtype=np.int32), SamplingParams())
    eng.submit(np.arange(4, dtype=np.int32), SamplingParams())
    with pytest.raises(AdmissionRejected) as ei:
        eng.submit(np.arange(4, dtype=np.int32), SamplingParams())
    assert ei.value.reason == "queue_full"
    assert ei.value.request_id == 2
    eng.shutdown(wait=False)


def test_unservable_requests_rejected():
    eng = InferenceEngine(_lm1(), EngineConfig(n_slots=1, max_len=32))
    with pytest.raises(AdmissionRejected) as ei:
        eng.submit(np.zeros(40, np.int32), SamplingParams())
    assert ei.value.reason == "prompt_too_long"
    with pytest.raises(AdmissionRejected) as ei:
        eng.submit(np.zeros(20, np.int32), SamplingParams(max_new_tokens=20))
    assert ei.value.reason == "too_long"
    with pytest.raises(AdmissionRejected) as ei:
        eng.submit(np.zeros(0, np.int32), SamplingParams())
    assert ei.value.reason == "invalid"


def test_priority_over_fcfs():
    eng = InferenceEngine(_lm1(), EngineConfig(n_slots=1, max_len=MAX_LEN))
    p = np.arange(4, dtype=np.int32)
    ha = eng.submit(p, SamplingParams(max_new_tokens=8, priority=5))
    hb = eng.submit(p, SamplingParams(max_new_tokens=4, priority=5))
    hc = eng.submit(p, SamplingParams(max_new_tokens=4, priority=0))
    with eng:
        for h in (ha, hb, hc):
            h.result(timeout=60)
    assert hc.metrics["admit_iteration"] < ha.metrics["admit_iteration"] \
        < hb.metrics["admit_iteration"]


def _slow_decode(eng, seconds):
    """Make every decode step of ``eng`` take at least ``seconds``."""
    fast = eng.pool.decode

    def delayed(*a, **k):
        time.sleep(seconds)
        return fast(*a, **k)
    eng.pool.decode = delayed
    return eng


def test_queued_deadline_typed_error():
    eng = _slow_decode(InferenceEngine(
        _lm1(), EngineConfig(n_slots=1, max_len=MAX_LEN)), 0.005)
    with eng:
        ha = eng.submit(np.arange(6, dtype=np.int32),
                        SamplingParams(max_new_tokens=50))
        hb = eng.submit(np.arange(4, dtype=np.int32),
                        SamplingParams(max_new_tokens=4, deadline_ms=20.0))
        with pytest.raises(RequestDeadlineExceeded) as ei:
            hb.result(timeout=60)
        assert len(ha.result(timeout=60)) == 50     # unaffected
    assert ei.value.stage == "queued"
    assert ei.value.deadline_ms == 20.0
    assert ei.value.request_id == hb.request_id


def test_running_deadline_typed_error():
    """A running request past its deadline fails typed, attributed to
    request and iteration, while a co-resident stream completes."""
    model = _lm1()
    ref = _gen(model, np.arange(8, dtype=np.int32),
               SamplingParams(max_new_tokens=20))
    eng = _slow_decode(InferenceEngine(
        model, EngineConfig(n_slots=2, max_len=128)), 0.02)
    with eng:
        ha = eng.submit(np.arange(5, dtype=np.int32),
                        SamplingParams(max_new_tokens=100, deadline_ms=150.0))
        hb = eng.submit(np.arange(8, dtype=np.int32),
                        SamplingParams(max_new_tokens=20))
        with pytest.raises(RequestDeadlineExceeded) as ei:
            ha.result(timeout=60)
        np.testing.assert_array_equal(hb.result(timeout=60), ref)
    assert ei.value.stage == "running"
    assert ei.value.request_id == ha.request_id
    assert ei.value.iteration is not None


def test_slo_metrics_flow_to_logger(tmp_path):
    log = tmp_path / "serve_metrics.jsonl"
    logger = MetricsLogger(path=str(log))
    try:
        with InferenceEngine(_lm1(), EngineConfig(
                n_slots=2, max_len=MAX_LEN, metrics=logger)) as eng:
            hs = [eng.submit(np.arange(5, dtype=np.int32),
                             SamplingParams(max_new_tokens=8))
                  for _ in range(3)]
            for h in hs:
                h.result(timeout=60)
    finally:
        logger.close()
    rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    reqs = [r for r in rows if r.get("event") == "serve_request"]
    assert len(reqs) == 3
    for r in reqs:
        assert r["outcome"] == "ok" and r["n_tokens"] == 8
        assert r["ttft_ms"] > 0 and r["tpot_ms"] > 0
        assert r["queue_ms"] is not None
    agg = aggregate(reqs, wall_s=1.0)
    assert agg["n_ok"] == 3 and agg["total_tokens"] == 24
    assert agg["tokens_per_sec"] == 24.0


def test_shutdown_fails_inflight_typed():
    eng = _slow_decode(InferenceEngine(
        _lm1(), EngineConfig(n_slots=1, max_len=128)), 0.005)
    eng.start()
    h = eng.submit(np.arange(4, dtype=np.int32),
                   SamplingParams(max_new_tokens=100))
    h2 = eng.submit(np.arange(4, dtype=np.int32),
                    SamplingParams(max_new_tokens=4))
    time.sleep(0.05)
    eng.shutdown()
    for handle in (h, h2):
        with pytest.raises(EngineStopped):
            handle.result(timeout=10)
    with pytest.raises(EngineStopped):
        eng.submit(np.arange(4, dtype=np.int32), SamplingParams())


def test_engine_loop_crash_fails_futures_typed():
    eng = InferenceEngine(_lm1(), EngineConfig(n_slots=1, max_len=MAX_LEN))

    def boom(*a, **k):
        raise RuntimeError("injected engine bug")
    eng.pool.admit = boom
    eng.start()
    h = eng.submit(np.arange(4, dtype=np.int32),
                   SamplingParams(max_new_tokens=4))
    with pytest.raises(EngineStopped) as ei:
        h.result(timeout=30)
    assert isinstance(ei.value.__cause__, RuntimeError)
    eng.shutdown()


def test_crash_before_start_drains_queue():
    eng = InferenceEngine(_lm1(), EngineConfig(n_slots=1, max_len=MAX_LEN))
    h = eng.submit(np.arange(4, dtype=np.int32), SamplingParams())
    cause = RuntimeError("replica lost")
    eng.crash(cause)
    with pytest.raises(EngineStopped) as ei:
        h.result(timeout=10)
    assert ei.value.__cause__ is cause


def test_streaming_callback_order():
    seen = []
    with InferenceEngine(_lm1(), EngineConfig(n_slots=1,
                                              max_len=MAX_LEN)) as eng:
        h = eng.submit(np.arange(5, dtype=np.int32),
                       SamplingParams(max_new_tokens=6),
                       on_token=lambda t, i: seen.append((i, t)))
        out = h.result(timeout=60)
    assert [i for i, _ in seen] == list(range(6))
    np.testing.assert_array_equal(np.asarray([t for _, t in seen]), out)


def test_engine_config_validation():
    model = _lm1()
    with pytest.raises(ValueError, match="n_slots"):
        InferenceEngine(model, EngineConfig(n_slots=0))
    with pytest.raises(ValueError, match="bucket"):
        InferenceEngine(model, EngineConfig(max_len=64, buckets=(8, 128)))
    learned = _lm1(pos="learned")
    with pytest.raises(ValueError, match="max_seq"):
        InferenceEngine(learned, EngineConfig(max_len=256))
    assert jax.devices()[0].platform == "cpu"   # the JAX side stays on CPU
