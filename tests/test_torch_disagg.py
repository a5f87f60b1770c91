"""The port's disaggregated prefill/decode serving (``serve/disagg/``)
against the JAX package's, and its engine contracts.

- Frames: the port's ``encode_frame`` / ``encode_frame_quantized`` give
  the JAX package's bytes on the same seeded pages and logits at f32,
  q8 and q4; ``decode_frame`` round-trips them as JAX's does, with and
  without ``keep_bits``; every damaged header, logits section or page
  raises ``HandoffCorrupt`` with JAX's ``page``, ``request_id`` and
  ``engine``.
- CRC32C: the host library's (``native/dpxhost.cpp``, built by the
  port) equals ``crc32c_sw`` and the JAX package's on empty, odd-length
  and 1 MB buffers.
- Pages: ``extract`` / ``extract_quantized`` equal the JAX pool's after
  an admit of the same prompt with the same weights (f32: rtol 1e-4,
  atol 1e-5, the float32 summation order; codes within one step, scales
  rtol 1e-4), zero past the length; ``adopt`` then one decode step
  equals the unsplit pool's decode bit for bit, ``adopt_quantized``
  installs the sender's codes bit for bit, the q8 one-step logit delta
  is <= 0.05 (JAX's bound), and adoption is all-or-nothing.
- Engine (``TestDisaggEngine`` / ``TestHandoffMetrics`` of the JAX
  suite, held to the port's own ``generate()``, and greedy tokens to
  JAX's ``generate()``): exact streams with cold, shared-prefix and
  sub-page prompts, hits [0, 2, 0], the booked bytes, every page freed;
  the q8 bound; victim-only prefill death and a typed ``HandoffTimeout``
  through transport doubles and through ``DPX_FAULT`` (``drop_conn`` /
  ``delay`` / ``flaky`` at ``handoff_send``, the last retried twice
  with equal streams); a corrupt frame failing only its victim; a
  prefill crash failing its request typed; submit validation, shutdown
  draining typed, a non-pollable transport and a windowed model
  refused; the TTFT decomposition and the log records; speculation on
  the decode side equal to the unspeculated stream.

Serial run time ~25 s.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, jax_and_port_lm, to_np
from distributed_pytorch_tpu.ckpt import integrity as jintegrity
from distributed_pytorch_tpu.models.generate import make_generate_fn
from distributed_pytorch_tpu.serve import pages as jpages
from distributed_pytorch_tpu.serve.disagg import frames as jframes
from distributed_pytorch_tpu.serve.types import HandoffCorrupt as JCorrupt
from distributed_pytorch_tpu_torch import TransformerLM, generate
from distributed_pytorch_tpu_torch.ckpt.integrity import crc32c, crc32c_sw
from distributed_pytorch_tpu_torch.comm import wire
from distributed_pytorch_tpu_torch.serve import (AdmissionRejected,
                                                 DisaggConfig, DisaggEngine,
                                                 EngineStopped,
                                                 HandoffCorrupt,
                                                 HandoffTimeout,
                                                 PagePoolExhausted,
                                                 PrefillEngineDied,
                                                 SamplingParams, aggregate,
                                                 request_record)
from distributed_pytorch_tpu_torch.serve.disagg import (LocalTransport,
                                                        TransportSevered,
                                                        decode_frame,
                                                        encode_frame,
                                                        encode_frame_quantized,
                                                        kv_wire_bytes,
                                                        resolve_handoff_bits)
from distributed_pytorch_tpu_torch.serve.pages import PagedSlotPool
from distributed_pytorch_tpu_torch.serve.pages.quant import quantize_pages_np
from distributed_pytorch_tpu_torch.serve.types import Request
from distributed_pytorch_tpu_torch.utils.logging import MetricsLogger

MAX_LEN = 64
L = 8   # page_len


def _lm1(**kw):
    kw = {**dict(vocab=61, dim=32, n_layers=1, n_heads=4, n_kv_heads=2,
                 pos="rope", max_seq=128), **kw}
    return TransformerLM(device=CPU, generator=torch.Generator()
                         .manual_seed(0), **kw)


def _disagg(model, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("page_len", L)
    transport = kw.pop("transport", None)
    return DisaggEngine(model, DisaggConfig(**kw), transport=transport)


def _gen(model, prompt, n, max_len=MAX_LEN):
    return generate(model, prompt[None], n, max_len=max_len)[0].numpy()


def _seeded_pages(seed, n_layers=2, n_pages=3, shape=(2, L, 8), vocab=61):
    rng = np.random.default_rng(seed)
    ks = [rng.standard_normal((n_pages,) + shape).astype(np.float32)
          for _ in range(n_layers)]
    vs = [rng.standard_normal((n_pages,) + shape).astype(np.float32)
          for _ in range(n_layers)]
    logits = rng.standard_normal(vocab).astype(np.float32)
    return logits, ks, vs


# ---------------------------------------------------------------------------
# the frame codec against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [None, 8, 4], ids=["f32", "q8", "q4"])
def test_encode_frame_bytes_equal_jax(bits):
    logits, ks, vs = _seeded_pages(1)
    ks[1][2, :, 5:] = 0.0            # a zero-padded last page
    got, got_kv = encode_frame(7, 21, logits, ks, vs, bits)
    want, want_kv = jframes.encode_frame(7, 21, logits, ks, vs, bits)
    assert got == want and got_kv == want_kv
    pe = ks[0][0].size
    assert got_kv == kv_wire_bytes(2, 3, pe, bits) == \
        wire.handoff_page_wire_bytes(pe, 12, bits=bits)
    assert len(got) == 12 * 8 + 4 * 13 + 4 * 61 + got_kv


@pytest.mark.parametrize("bits", [8, 4], ids=["q8", "q4"])
def test_encode_frame_quantized_bytes_equal_jax(bits):
    logits, ks, vs = _seeded_pages(2)
    kqs = [quantize_pages_np(k, bits) for k in ks]
    vqs = [quantize_pages_np(v, bits) for v in vs]
    got = encode_frame_quantized(3, 24, logits, kqs, vqs, bits)
    want = jframes.encode_frame_quantized(3, 24, logits, kqs, vqs, bits)
    assert got == want
    # the same codes as an exact extract requantized on the wire
    assert got == encode_frame(3, 24, logits, ks, vs, bits)


@pytest.mark.parametrize("bits,keep", [(None, None), (8, None), (4, None),
                                       (8, 8), (4, 4), (8, 4)],
                         ids=["f32", "q8", "q4", "q8-keep", "q4-keep",
                              "q8-keep4"])
def test_decode_frame_round_trip_equals_jax(bits, keep):
    logits, ks, vs = _seeded_pages(3)
    buf, kv_bytes = encode_frame(11, 20, logits, ks, vs, bits)
    got = decode_frame(buf, keep_bits=keep)
    want = jframes.decode_frame(buf, keep_bits=keep)
    assert (got.request_id, got.length, got.bits, got.kv_bytes,
            got.quantized) == (want.request_id, want.length, want.bits,
                               want.kv_bytes, want.quantized)
    assert got.quantized == (bits is not None and keep == bits)
    np.testing.assert_array_equal(got.logits, logits)
    for a, b in zip(got.ks + got.vs, want.ks + want.vs):
        if got.quantized:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        else:
            np.testing.assert_array_equal(a, b)
    if bits is None:
        for a, b in zip(got.ks + got.vs, ks + vs):
            np.testing.assert_array_equal(a, b)


def _damage(buf, kind, n_tensors, vocab=61):
    bad = bytearray(buf)
    off_kv = 12 * 8 + 4 * (1 + n_tensors) + 4 * vocab
    if kind == "last_page":
        bad[-1] ^= 0xFF
    elif kind == "first_page":
        bad[off_kv] ^= 0xFF
    elif kind == "logits":
        bad[12 * 8 + 4 * (1 + n_tensors)] ^= 0xFF
    elif kind == "crc_table":
        bad[12 * 8 + 4] ^= 0xFF
    elif kind == "magic":
        bad[:8] = np.int64(0).tobytes()
    elif kind == "truncated":
        return bytes(bad[:40])
    elif kind == "short_body":
        return bytes(bad[:-3])
    else:                                  # a geometry word
        word, value = kind
        bad[word * 8:(word + 1) * 8] = np.int64(value).tobytes()
    return bytes(bad)


@pytest.mark.parametrize("kind", [
    "last_page", "first_page", "logits", "crc_table", "magic", "truncated",
    "short_body", (3, 9), (3, -8), (5, 1 << 40), (4, 0), (9, 10_000),
    (10, -1)], ids=str)
def test_corrupt_frame_typed_like_jax(kind):
    logits, ks, vs = _seeded_pages(4)
    buf, _ = encode_frame(5, 20, logits, ks, vs, 8)
    bad = _damage(buf, kind, 12)
    with pytest.raises(HandoffCorrupt) as got:
        decode_frame(bad)
    with pytest.raises(JCorrupt) as want:
        jframes.decode_frame(bad)
    assert (got.value.page, got.value.request_id, got.value.engine) == \
        (want.value.page, want.value.request_id, want.value.engine)
    if kind == "last_page":
        assert got.value.page == 11 and got.value.request_id == 5
    if kind == "first_page":
        assert got.value.page == 0


def test_width_resolution():
    assert resolve_handoff_bits("f32") is None
    assert resolve_handoff_bits("q8") == 8
    assert resolve_handoff_bits("q4") == 4
    with pytest.raises(ValueError, match="handoff width"):
        resolve_handoff_bits("q2")


@pytest.mark.parametrize("n", [0, 1, 1001, 1 << 20],
                         ids=["empty", "one", "odd", "1MB"])
def test_native_crc32c_equals_sw_and_jax(n):
    buf = np.random.default_rng(n).integers(0, 256, n).astype(
        np.uint8).tobytes()
    got = crc32c(buf)
    assert got == crc32c_sw(buf) == jintegrity.crc32c(buf)
    assert got == crc32c(np.frombuffer(buf, np.uint8))


def test_native_library_is_built_from_the_repo_source():
    from distributed_pytorch_tpu_torch.runtime import native
    crc32c(b"x")
    path = native.library_path()
    assert path.exists() and path.parent.name == "torch_native"
    assert native.SOURCE.name == "dpxhost.cpp"
    assert crc32c(b"123456789") == 0xE3069283      # the CRC32C check value


# ---------------------------------------------------------------------------
# extract / adopt against the JAX pool and the unsplit decode
# ---------------------------------------------------------------------------

def _admit_both(kv_dtype="f32", seed=2, lens=(30, 20)):
    """The same prompts admitted (one after another into slot 0, the
    first released, so the second reuses a dirty page) in the JAX pool
    and the port's, same weights; returns both pools and the prompt."""
    jm, params, pm = jax_and_port_lm(seed=seed)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 61, n).astype(np.int32) for n in lens]
    jpool = jpages.PagedSlotPool(jm, 1, MAX_LEN, page_len=L, n_pages=8,
                                 prefix_share=False, kv_dtype=kv_dtype)
    tpool = PagedSlotPool(pm, 1, MAX_LEN, page_len=L, n_pages=8,
                          prefix_share=False, kv_dtype=kv_dtype)
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            if i:
                jpool.release(0)
                tpool.release(0)
            jl = jpool.admit(params, p, 0, (32,))[0]
            tl = tpool.admit(p, 0, (32,))[0]
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    return jpool, tpool, pm, prompts[-1]


@pytest.mark.parametrize("kv_dtype", ["f32", "q8", "q4"])
def test_extract_equals_jax(kv_dtype):
    jpool, tpool, pm, prompt = _admit_both(kv_dtype)
    jlen, jks, jvs = jpool.extract(0)
    tlen, tks, tvs = tpool.extract(0)
    assert tlen == jlen == len(prompt)
    valid = len(prompt) - 2 * L
    for a, b in zip(tks + tvs, jks + jvs):
        assert a.dtype == np.float32 and a.shape == b.shape == (3, 2, L, 8)
        # a quantized pool's full pages carry its own rounding: one step
        # of the page's scale where the two packages' values straddle it
        atol = 1e-5 if kv_dtype == "f32" else np.abs(b).max() / (
            127 if kv_dtype == "q8" else 7) + 1e-5
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)
        np.testing.assert_allclose(a[-1], b[-1], rtol=1e-4, atol=1e-5)
        assert not a[-1, :, valid:].any()      # zeroed past the length
        assert a[-1, :, :valid].any()


@pytest.mark.parametrize("kv_dtype", ["q8", "q4"])
def test_extract_quantized_equals_jax(kv_dtype):
    jpool, tpool, pm, prompt = _admit_both(kv_dtype)
    _, jkq, jvq = jpool.extract_quantized(0)
    _, tkq, tvq = tpool.extract_quantized(0)
    for (tq, ts), (jq, js) in zip(tkq + tvq, jkq + jvq):
        assert tq.dtype == np.int8 and tq.shape == jq.shape
        np.testing.assert_allclose(ts, js, rtol=1e-4)
        assert np.abs(tq.astype(np.int32) - jq).max() <= 1
        assert (tq != jq).mean() < 0.01
    # the resident codes are the pool's own: an exact extract requantized
    # gives the same codes
    _, ks, _ = tpool.extract(0)
    q, _ = quantize_pages_np(ks[0], 8 if kv_dtype == "q8" else 4)
    np.testing.assert_array_equal(q[:-1], tkq[0][0][:-1])


def _unsplit_and_adopted(kv_dtype, via_bits="same"):
    """Prefill a prompt into slot 1 of one pool (a neighbour in slot 0)
    and decode one step there; hand its pages (frame width
    ``via_bits``) to slot 1 of a like pool of ``kv_dtype`` beside the
    same neighbour and decode the same step there."""
    pm = _lm1(n_layers=2)
    prompt = np.random.default_rng(6).integers(0, 61, 20).astype(np.int32)
    pools = [PagedSlotPool(pm, 2, MAX_LEN, page_len=L, n_pages=8,
                           prefix_share=False, kv_dtype=kv_dtype)
             for _ in range(2)]
    src, dst = pools
    tok = torch.tensor([3, int(prompt[-1])])
    active = np.array([False, True])
    with torch.inference_mode():
        for pool in pools:
            pool.admit(np.arange(5, dtype=np.int32), 0, (32,))
        lg = src.admit(prompt, 1, (32,))[0]
        bits = src.quant_bits if via_bits == "same" else via_bits
        if bits is not None and bits == src.quant_bits:
            length, ks, vs = src.extract_quantized(1)
            buf = encode_frame_quantized(0, length, to_np(lg)[0], ks, vs,
                                         bits)[0]
        else:
            length, ks, vs = src.extract(1)
            buf = encode_frame(0, length, to_np(lg)[0], ks, vs, bits)[0]
        fr = decode_frame(buf, keep_bits=dst.quant_bits)
        (dst.adopt_quantized if fr.quantized else dst.adopt)(
            1, fr.length, fr.ks, fr.vs)
        for pool in pools:
            pool.ensure_decode_capacity(1)
        ref = src.decode(tok, active)[1]
        got = dst.decode(tok, active)[1]
    return src, dst, fr, to_np(ref), to_np(got)


def test_adopt_then_decode_equals_unsplit_bitwise():
    src, dst, fr, ref, got = _unsplit_and_adopted("f32")
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(src.k_pages + src.v_pages, dst.k_pages + dst.v_pages):
        np.testing.assert_array_equal(
            to_np(a[src.owned[1]]), to_np(b[dst.owned[1]]))


def test_adopt_quantized_installs_the_senders_codes():
    src, dst, fr, ref, got = _unsplit_and_adopted("q8")
    assert fr.quantized
    for a, b in zip(src.k_pages + src.v_pages + src.k_scales
                    + src.v_scales, dst.k_pages + dst.v_pages
                    + dst.k_scales + dst.v_scales):
        np.testing.assert_array_equal(
            to_np(a[src.owned[1][:2]]), to_np(b[dst.owned[1][:2]]))
    assert np.abs(got - ref).max() <= 0.05


@pytest.mark.parametrize("width,bound", [(8, 0.05), (4, 0.5)],
                         ids=["q8", "q4"])
def test_quantized_frame_one_step_logit_delta(width, bound):
    _, _, _, ref, got = _unsplit_and_adopted("f32", via_bits=width)
    assert np.abs(got - ref).max() <= bound


def test_adopt_is_all_or_nothing_when_exhausted():
    pm = _lm1()
    pool = PagedSlotPool(pm, 2, MAX_LEN, page_len=L, n_pages=4,
                         prefix_share=False)
    with torch.inference_mode():
        pool.admit(np.arange(20, dtype=np.int32), 0, (32,))
        _, ks, vs = pool.extract(0)
        free = pool.pool.free_pages
        with pytest.raises(PagePoolExhausted):
            pool.adopt(1, 20, ks, vs)
    assert pool.pool.free_pages == free and pool.owned[1] == []
    assert pool.lengths[1] == 0


# ---------------------------------------------------------------------------
# the split engine
# ---------------------------------------------------------------------------

def _jax_generate(jm, params, prompt, n):
    fn = make_generate_fn(jm, n, max_len=MAX_LEN)
    return np.asarray(jax.jit(fn)(params, jnp.asarray(prompt[None]),
                                  jax.random.PRNGKey(0)))[0]


def test_exact_streams_equal_generate_and_jax():
    """Cold, shared-prefix and sub-page prompts through the split: every
    greedy stream equals the port's generate() and JAX's generate() on
    the same weights; the prefill side decodes nothing and the decode
    side prefills nothing; prefill-side radix hits [0, 2, 0]; the booked
    bytes equal the wire formula; every page is free afterwards."""
    jm, params, pm = jax_and_port_lm(seed=0, n_layers=1)
    rng = np.random.default_rng(12)
    pfx = rng.integers(0, 61, (16,)).astype(np.int32)   # 2 full pages
    prompts = [
        np.concatenate([pfx, rng.integers(0, 61, (4,))]).astype(np.int32),
        np.concatenate([pfx, rng.integers(0, 61, (4,))]).astype(np.int32),
        rng.integers(0, 61, (7,)).astype(np.int32)]
    sp = SamplingParams(max_new_tokens=8)
    eng = _disagg(pm)
    with eng:
        hs = [eng.submit(p, sp) for p in prompts]
        outs = [h.result(timeout=120) for h in hs]
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(outs[i], _gen(pm, p, 8),
                                      err_msg=f"request {i}")
        np.testing.assert_array_equal(outs[i], _jax_generate(jm, params,
                                                             p, 8))
    st = eng.stats()
    assert st["prefill"]["decode_steps"] == 0
    assert st["decode"]["prefill_admits"] == {}
    assert [h.metrics["prefix_hit_pages"] for h in hs] == [0, 2, 0]
    assert [h.metrics["prefill_tokens_saved"] for h in hs] == [0, 16, 0]
    pe = pm.n_kv_heads * L * (pm.dim // pm.n_heads)
    want = sum(kv_wire_bytes(pm.n_layers, -(-len(p) // L), pe, None)
               for p in prompts)
    assert st["handoff"]["bytes_sent"] == want
    assert st["handoff"]["bytes_recv"] == want
    assert want == sum(h.metrics["handoff_bytes"] for h in hs)
    assert st["handoff"]["frames_sent"] == st["handoff"]["frames_recv"] == 3
    assert eng.decode.pool.pool.live_pages() == 0
    assert eng.prefill.pool.pool.live_pages() == 0
    assert eng.decode.pool.pool.free_pages == eng.decode.pool.n_pages


@pytest.mark.parametrize("width,kv_dtype", [("q8", "f32"), ("q4", "f32"),
                                            ("q8", "q8")],
                         ids=["q8-wire", "q4-wire", "q8-passthrough"])
def test_quantized_handoff_bound(width, kv_dtype):
    """>= 3.5x (q8) / 6.5x (q4) fewer handoff bytes than f32, booked ==
    formula, first token exact (the logits ship f32), token divergence
    from generate() <= 25% at q8 (JAX's bound)."""
    pm = _lm1()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 61, (s,)).astype(np.int32)
               for s in (20, 12, 7, 17)]
    sp = SamplingParams(max_new_tokens=10)
    refs = [_gen(pm, p, 10) for p in prompts]
    eng = _disagg(pm, handoff_width=width, kv_dtype=kv_dtype)
    with eng:
        outs = [eng.submit(p, sp).result(timeout=120) for p in prompts]
    bits = resolve_handoff_bits(width)
    pe = pm.n_kv_heads * L * (pm.dim // pm.n_heads)
    q_want = sum(kv_wire_bytes(1, -(-len(p) // L), pe, bits)
                 for p in prompts)
    f32_want = sum(kv_wire_bytes(1, -(-len(p) // L), pe, None)
                   for p in prompts)
    assert eng.stats()["handoff"]["bytes_sent"] == q_want
    assert f32_want / q_want >= (3.5 if bits == 8 else 6.5)
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert o[0] == r[0], f"request {i}: first token must be exact"
    if bits == 8:
        assert max(float(np.mean(o != r)) for o, r in zip(outs, refs)) \
            <= 0.25
    assert eng.decode.pool.pool.live_pages() == 0


class _SeverOnSecondSend(LocalTransport):
    """The prefill side's channel dies entering its second send (the
    in-process analogue of the prefill engine dying mid-handoff)."""

    def send(self, frame, kv_bytes):
        if self.frames_sent == 1:
            self.abort()
        super().send(frame, kv_bytes)


def test_prefill_death_mid_handoff_fails_victims_only():
    """The victim and the still-queued request fail PrefillEngineDied
    blaming the prefill engine, later submissions are refused with
    reason prefill_dead, and the stream already decoding finishes equal
    to generate()."""
    pm = _lm1()
    rng = np.random.default_rng(8)
    a = rng.integers(0, 61, (9,)).astype(np.int32)
    b = rng.integers(0, 61, (12,)).astype(np.int32)
    c = rng.integers(0, 61, (5,)).astype(np.int32)
    sp = SamplingParams(max_new_tokens=20)
    eng = _disagg(pm, n_slots=2, transport=_SeverOnSecondSend())
    with eng:
        ha = eng.submit(a, sp)
        while not ha.tokens:   # a decodes before b's handoff
            time.sleep(0.005)
        hb = eng.submit(b, sp)
        with pytest.raises(PrefillEngineDied) as ei:
            hb.result(timeout=60)
        out_a = ha.result(timeout=60)
        with pytest.raises(AdmissionRejected) as rej:
            eng.submit(c, sp)
    assert ei.value.request_id == hb.request_id
    assert ei.value.engine == "prefill"
    assert isinstance(ei.value.__cause__, TransportSevered)
    assert hb.metrics["outcome"] == "prefill_died"
    assert rej.value.reason == "prefill_dead"
    np.testing.assert_array_equal(out_a, _gen(pm, a, 20))
    assert eng.decode.pool.pool.live_pages() == 0


class _DelaySecondSend(LocalTransport):
    def send(self, frame, kv_bytes):
        if self.frames_sent == 1:
            time.sleep(0.6)
        super().send(frame, kv_bytes)


def test_handoff_timeout_typed():
    """A frame that arrives past DPX_HANDOFF_TIMEOUT_MS fails its
    request as a typed HandoffTimeout; the late frame is dropped and the
    co-resident stream is untouched."""
    pm = _lm1()
    rng = np.random.default_rng(9)
    a = rng.integers(0, 61, (9,)).astype(np.int32)
    b = rng.integers(0, 61, (6,)).astype(np.int32)
    sp = SamplingParams(max_new_tokens=24)
    eng = _disagg(pm, n_slots=2, handoff_timeout_ms=80,
                  transport=_DelaySecondSend())
    with eng:
        ha = eng.submit(a, sp)
        while not ha.tokens:
            time.sleep(0.005)
        hb = eng.submit(b, sp)
        with pytest.raises(HandoffTimeout) as ei:
            hb.result(timeout=60)
        out_a = ha.result(timeout=60)
    assert ei.value.request_id == hb.request_id
    assert ei.value.deadline_ms == 80.0
    assert ei.value.engine == "transport"
    np.testing.assert_array_equal(out_a, _gen(pm, a, 24))
    assert eng.decode.pool.pool.live_pages() == 0


# -- the same cases through DPX_FAULT (the JAX package's chaos tests) ----

@pytest.fixture
def armed():
    from distributed_pytorch_tpu_torch.runtime import faults
    faults.reset()
    yield faults
    faults.reset()


def test_dpx_fault_drop_conn_mid_handoff_fails_victims_only(armed):
    """JAX's ``test_chaos_prefill_death_mid_handoff_victim_only``:
    ``drop_conn@op=handoff_send,call=2`` severs the transport entering
    the second handoff; the victim fails ``PrefillEngineDied`` and the
    decoding stream finishes equal to ``generate()``."""
    pm = _lm1()
    rng = np.random.default_rng(8)
    a = rng.integers(0, 61, (9,)).astype(np.int32)
    b = rng.integers(0, 61, (12,)).astype(np.int32)
    sp = SamplingParams(max_new_tokens=20)
    armed.install("drop_conn@op=handoff_send,call=2")
    eng = _disagg(pm, n_slots=2)
    with eng:
        ha = eng.submit(a, sp)
        while not ha.tokens:
            time.sleep(0.005)
        hb = eng.submit(b, sp)
        with pytest.raises(PrefillEngineDied) as ei:
            hb.result(timeout=60)
        out_a = ha.result(timeout=60)
        with pytest.raises(AdmissionRejected) as rej:
            eng.submit(a, sp)
    assert ei.value.request_id == hb.request_id
    assert ei.value.engine == "prefill"
    assert rej.value.reason == "prefill_dead"
    np.testing.assert_array_equal(out_a, _gen(pm, a, 20))
    assert armed.fired() == ["drop_conn@op=handoff_send,call=2"]
    assert eng.decode.pool.pool.live_pages() == 0


def test_dpx_fault_delayed_handoff_is_a_typed_timeout(armed):
    """JAX's ``test_handoff_timeout_typed``: the second send stalled
    past ``DPX_HANDOFF_TIMEOUT_MS`` by ``delay@op=handoff_send,call=2``
    fails its request as ``HandoffTimeout``; the other stream is
    untouched."""
    pm = _lm1()
    rng = np.random.default_rng(9)
    a = rng.integers(0, 61, (9,)).astype(np.int32)
    b = rng.integers(0, 61, (6,)).astype(np.int32)
    sp = SamplingParams(max_new_tokens=24)
    armed.install("delay@op=handoff_send,call=2,ms=600")
    eng = _disagg(pm, n_slots=2, handoff_timeout_ms=80)
    with eng:
        ha = eng.submit(a, sp)
        while not ha.tokens:
            time.sleep(0.005)
        hb = eng.submit(b, sp)
        with pytest.raises(HandoffTimeout) as ei:
            hb.result(timeout=60)
        out_a = ha.result(timeout=60)
    assert ei.value.request_id == hb.request_id
    assert ei.value.deadline_ms == 80.0
    assert ei.value.engine == "transport"
    np.testing.assert_array_equal(out_a, _gen(pm, a, 24))


def test_dpx_fault_flaky_handoff_recovers_exactly(armed, tmp_path,
                                                  monkeypatch):
    """``flaky@op=handoff_send,count=2``: the handoff is retried twice
    (two ``comm_retry`` events) and every stream equals ``generate()``."""
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("DPX_METRICS_LOG", str(log))
    monkeypatch.setenv("DPX_RETRY_BACKOFF_MS", "1")
    pm = _lm1()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 61, (n,)).astype(np.int32) for n in (9, 6)]
    sp = SamplingParams(max_new_tokens=8)
    armed.install("flaky@op=handoff_send,count=2")
    eng = _disagg(pm, n_slots=2)
    with eng:
        outs = [h.result(timeout=60) for h in
                [eng.submit(p, sp) for p in prompts]]
    for p, out in zip(prompts, outs):
        np.testing.assert_array_equal(out, _gen(pm, p, 8))
    evs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [(e["op"], e["attempt"]) for e in evs
            if e.get("event") == "comm_retry"] == [("handoff_send", 1),
                                                   ("handoff_send", 2)]


class _FlipSecondFrame(LocalTransport):
    def send(self, frame, kv_bytes):
        if self.frames_sent == 1:
            frame = bytearray(frame)
            frame[-1] ^= 0xFF
            frame = bytes(frame)
        super().send(frame, kv_bytes)


def test_corrupt_frame_fails_victim_only():
    pm = _lm1()
    rng = np.random.default_rng(10)
    a = rng.integers(0, 61, (9,)).astype(np.int32)
    b = rng.integers(0, 61, (6,)).astype(np.int32)
    c = rng.integers(0, 61, (11,)).astype(np.int32)
    sp = SamplingParams(max_new_tokens=16)
    eng = _disagg(pm, n_slots=2, transport=_FlipSecondFrame())
    with eng:
        ha = eng.submit(a, sp)
        while not ha.tokens:
            time.sleep(0.005)
        hb = eng.submit(b, sp)
        with pytest.raises(HandoffCorrupt) as ei:
            hb.result(timeout=60)
        out_c = eng.submit(c, sp).result(timeout=60)
        out_a = ha.result(timeout=60)
    assert ei.value.request_id == hb.request_id and ei.value.page >= 0
    assert hb.metrics["outcome"] == "handoff_corrupt"
    np.testing.assert_array_equal(out_a, _gen(pm, a, 16))
    np.testing.assert_array_equal(out_c, _gen(pm, c, 16))


def test_prefill_crash_fails_the_active_request_typed():
    """A crash inside the prefill compute fails the request being
    prefilled (and the queued ones) typed PrefillEngineDied, with the
    cause chained; nothing is left unresolved."""
    pm = _lm1()
    eng = _disagg(pm, n_slots=2)

    def boom(*a, **k):
        raise RuntimeError("injected prefill bug")
    eng.prefill.pool.admit = boom
    with eng:
        hs = [eng.submit(np.arange(6, dtype=np.int32) + i,
                         SamplingParams(max_new_tokens=4))
              for i in range(2)]
        for h in hs:
            with pytest.raises(PrefillEngineDied) as ei:
                h.result(timeout=30)
            assert ei.value.request_id == h.request_id
            assert isinstance(ei.value.__cause__, RuntimeError)
    assert eng.stats()["failed"] == 2


def test_submit_validation_typed():
    pm = _lm1()
    eng = _disagg(pm, n_slots=1)
    for prompt, n, reason in ((80, 4, "prompt_too_long"),
                              (40, 40, "too_long"), (0, 4, "invalid")):
        with pytest.raises(AdmissionRejected) as ei:
            eng.submit(np.arange(prompt, dtype=np.int32),
                       SamplingParams(max_new_tokens=n))
        assert ei.value.reason == reason
    small = _disagg(pm, n_slots=1, max_len=32, n_pages=2)
    with pytest.raises(AdmissionRejected) as ei:
        small.submit(np.arange(10, dtype=np.int32),
                     SamplingParams(max_new_tokens=10))
    assert ei.value.reason == "no_free_pages"
    with pytest.raises(ValueError, match="bucket"):
        _disagg(pm, buckets=(8, 128))


def test_tenant_quota_typed(monkeypatch):
    monkeypatch.setenv("DPX_SERVE_TENANT_MAX_INFLIGHT", "1")
    eng = _disagg(_lm1())       # never started: requests stay queued
    eng.submit(np.arange(6, dtype=np.int32), tenant="a")
    with pytest.raises(AdmissionRejected) as ei:
        eng.submit(np.arange(6, dtype=np.int32), tenant="a")
    assert ei.value.reason == "tenant_quota" and ei.value.tenant == "a"
    eng.submit(np.arange(6, dtype=np.int32), tenant="b")
    eng.shutdown()


def test_shutdown_drains_typed():
    eng = _disagg(_lm1())
    h = eng.submit(np.arange(6, dtype=np.int32),
                   SamplingParams(max_new_tokens=4))
    eng.shutdown()           # never started: the queued request drains
    with pytest.raises(EngineStopped) as ei:
        h.result(timeout=10)
    assert ei.value.request_id == h.request_id
    with pytest.raises(EngineStopped):
        eng.submit(np.arange(6, dtype=np.int32))


def test_nonpollable_transport_rejected():
    class Blocking(LocalTransport):
        pollable = False

    with pytest.raises(ValueError, match="not pollable"):
        _disagg(_lm1(), transport=Blocking())


def test_windowed_model_rejected():
    from distributed_pytorch_tpu_torch.nn.attention import dense_attention

    def fn(q, k, v, *, causal=False, scale=None):
        return dense_attention(q, k, v, causal=causal, scale=scale,
                               window=8)
    fn.window = 8
    with pytest.raises(ValueError, match="sliding-window"):
        _disagg(_lm1(vocab=64, attn_fn=fn))


def test_spec_decode_side_equals_unspeculated():
    """Speculation lives on the decode side: a self-draft accepts every
    proposal and the greedy streams equal generate(); a sampled request
    shares the batch unspeculated. 13 = 1 + 3 (k + 1) new tokens: no
    iteration is cut short by the budget."""
    pm = _lm1()
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, 61, (n,)).astype(np.int32)
               for n in (13, 9, 20)]
    sp = SamplingParams(max_new_tokens=13)
    eng = _disagg(pm, spec_decode=True, draft_model=pm, draft_len=3)
    with eng:
        hs = [eng.submit(p, sp) for p in prompts]
        hs.append(eng.submit(prompts[0], SamplingParams(
            max_new_tokens=6, temperature=0.8, top_k=8),
            generator=torch.Generator().manual_seed(4)))
        outs = [h.result(timeout=120) for h in hs]
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _gen(pm, p, 13))
    sampled = generate(pm, prompts[0][None], 6, temperature=0.8, top_k=8,
                       generator=torch.Generator().manual_seed(4),
                       max_len=MAX_LEN)[0].numpy()
    np.testing.assert_array_equal(outs[-1], sampled)
    spec = eng.stats()["decode"]["spec"]
    assert spec["acceptance_rate"] == 1.0 and spec["proposed"] > 0
    assert eng.decode.pool.pool.live_pages() == 0


# ---------------------------------------------------------------------------
# metrics: the TTFT decomposition
# ---------------------------------------------------------------------------

def _req(rid, t0=100.0, queue=0.010, prefill=0.020, handoff=0.005,
         decode=0.003, n_tokens=4, tpot=0.002, nbytes=1000):
    r = Request(request_id=rid, prompt=np.arange(9, dtype=np.int32),
                params=SamplingParams(max_new_tokens=n_tokens),
                generator=None, submit_t=t0, deadline_t=None)
    r.admit_t = t0 + queue
    r.handoff_send_t = r.admit_t + prefill
    r.handoff_recv_t = r.handoff_send_t + handoff
    r.first_token_t = r.handoff_recv_t + decode
    r.last_token_t = r.first_token_t + tpot * (n_tokens - 1)
    r.out_tokens = list(range(n_tokens))
    r.handoff_bytes = nbytes
    return r


def test_record_decomposition_sums_to_ttft():
    rec = request_record(_req(1), "ok")
    assert rec["queue_ms"] == pytest.approx(10.0)
    assert rec["prefill_ms"] == pytest.approx(20.0)
    assert rec["handoff_ms"] == pytest.approx(5.0)
    assert rec["decode_ms"] == pytest.approx(3.0)
    assert rec["handoff_bytes"] == 1000
    assert (rec["queue_ms"] + rec["prefill_ms"] + rec["handoff_ms"]
            + rec["decode_ms"]) == pytest.approx(rec["ttft_ms"])
    # TPOT is decode-engine time only: a 100x longer prefill leaves it
    assert rec["tpot_ms"] == pytest.approx(2.0)
    slow = request_record(_req(2, prefill=2.0), "ok")
    assert slow["tpot_ms"] == pytest.approx(2.0)
    assert slow["prefill_ms"] == pytest.approx(2000.0)


def test_aggregate_handoff_view():
    recs = [request_record(_req(i, handoff=0.004 + 0.002 * i,
                                nbytes=500 * (i + 1)), "ok")
            for i in range(5)]
    agg = aggregate(recs)
    assert agg["handoff_ms_p50"] == pytest.approx(8.0)
    assert agg["handoff_ms_p99"] == pytest.approx(12.0)
    assert agg["handoff_bytes"] == 500 * 15
    assert agg["prefill_ms_p50"] == pytest.approx(20.0)
    mono = dict(recs[0])
    for k in ("prefill_ms", "handoff_ms", "decode_ms", "handoff_bytes"):
        mono.pop(k)
    assert "handoff_ms_p50" not in aggregate([mono])


def test_engine_metrics_flow_to_logger(tmp_path):
    """serve_request events carry the decomposition and the handoff
    bytes, every span nonnegative and summing to TTFT; the split's
    gauges arrive as metrics_snapshot events."""
    pm = _lm1()
    rng = np.random.default_rng(11)
    log = tmp_path / "disagg.jsonl"
    logger = MetricsLogger(path=str(log))
    eng = _disagg(pm, metrics=logger, log_every=2)
    with eng:
        hs = [eng.submit(rng.integers(0, 61, (9,)).astype(np.int32),
                         SamplingParams(max_new_tokens=6))
              for _ in range(3)]
        for h in hs:
            h.result(timeout=120)
    logger.close()
    rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    reqs = [r for r in rows if r.get("event") == "serve_request"]
    assert len(reqs) == 3
    for r in reqs:
        for k in ("queue_ms", "prefill_ms", "handoff_ms", "decode_ms"):
            assert r[k] is not None and r[k] >= 0, (k, r)
        assert r["handoff_bytes"] > 0
        assert (r["queue_ms"] + r["prefill_ms"] + r["handoff_ms"]
                + r["decode_ms"]) == pytest.approx(r["ttft_ms"], rel=1e-6)
    for h in hs:
        assert h._request.handoff_recv_t <= h._request.first_token_t
    snaps = [r for r in rows if r.get("event") == "metrics_snapshot"]
    assert snaps and all(s["source"] == "serve_disagg_engine"
                         for s in snaps)
    assert "serve.handoff_bytes_sent" in snaps[-1]["metrics"]
    agg = aggregate([h.metrics for h in hs])
    assert agg["handoff_bytes"] == sum(h.metrics["handoff_bytes"]
                                       for h in hs)


# ---------------------------------------------------------------------------
# the registry and the wire accounting against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["DPX_SERVE_DISAGG", "DPX_HANDOFF_WIDTH",
                                  "DPX_HANDOFF_TIMEOUT_MS",
                                  "DPX_FLEET_REPLICAS",
                                  "DPX_FLEET_SPILL_QUEUE", "DPX_FAULT",
                                  "DPX_CHAOS", "DPX_CHAOS_WORLD",
                                  "DPX_ELASTIC_ATTEMPT", "DPX_ELASTIC",
                                  "DPX_PLATFORM", "DPX_WORKER_TAG",
                                  "DPX_ELASTIC_TEST_LEAK", "DPX_RETRY_MAX",
                                  "DPX_RETRY_BACKOFF_MS"])
def test_env_defaults_equal_jax(name):
    from distributed_pytorch_tpu.runtime import env as jenv
    from distributed_pytorch_tpu_torch.runtime import env as tenv
    got, want = tenv.REGISTRY[name], jenv.REGISTRY[name]
    assert (got.type, got.default) == (want.type, want.default)
    assert tenv.get(name) == jenv.get(name)


def test_wire_accounting_equals_jax():
    from distributed_pytorch_tpu.comm import wire as jwire
    assert wire.SCALE_BYTES == jwire.SCALE_BYTES
    for n in (1, 7, 1023, 1024, 1025, 12288, 100_001):
        for bits in (8, 4):
            assert wire.payload_bytes(n, bits) == jwire.payload_bytes(n, bits)
            assert wire.quant_wire_bytes(n, bits=bits) == \
                jwire.quant_wire_bytes(n, bits=bits)
        for bits in (None, 8, 4):
            assert wire.handoff_page_wire_bytes(n, 24, bits=bits) == \
                jwire.handoff_page_wire_bytes(n, 24, bits=bits)
    with pytest.raises(ValueError):
        wire.payload_bytes(8, bits=2)


def test_deadline_mid_decode_fails_only_its_request():
    from distributed_pytorch_tpu_torch.serve import RequestDeadlineExceeded
    pm = _lm1()
    rng = np.random.default_rng(15)
    a = rng.integers(0, 61, (9,)).astype(np.int32)
    b = rng.integers(0, 61, (7,)).astype(np.int32)
    eng = _disagg(pm, n_slots=2)
    with eng:
        ha = eng.submit(a, SamplingParams(max_new_tokens=12))
        hb = eng.submit(b, SamplingParams(max_new_tokens=50,
                                          deadline_ms=1.0))
        with pytest.raises(RequestDeadlineExceeded) as ei:
            hb.result(timeout=60)
        out_a = ha.result(timeout=60)
    assert ei.value.request_id == hb.request_id
    assert ei.value.stage in ("queued", "running")
    np.testing.assert_array_equal(out_a, _gen(pm, a, 12))
    assert eng.decode.pool.pool.live_pages() == 0


def test_decode_crash_fails_every_request_typed_and_frees_pages():
    """A decode-loop crash fails every request typed: the resident and
    queued ones EngineStopped with the crash chained (one caught inside
    its prefill when the transport closed may fail PrefillEngineDied),
    refuses new submissions and returns the decode pool's pages."""
    pm = _lm1()
    eng = _disagg(pm, n_slots=2)

    def boom(*a, **k):
        raise RuntimeError("injected decode bug")
    eng.decode.pool.decode = boom
    with eng:
        hs = [eng.submit(np.arange(6, dtype=np.int32) + i,
                         SamplingParams(max_new_tokens=4))
              for i in range(3)]
        errs = []
        for h in hs:
            with pytest.raises((EngineStopped, PrefillEngineDied)) as ei:
                h.result(timeout=30)
            assert ei.value.request_id == h.request_id
            errs.append(ei.value)
        with pytest.raises(EngineStopped):
            eng.submit(np.arange(6, dtype=np.int32))
    assert isinstance(errs[0], EngineStopped)
    assert isinstance(errs[0].__cause__, RuntimeError)
    assert eng.decode.pool.pool.live_pages() == 0
