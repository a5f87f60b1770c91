"""The port's paged, prefix-shared KV pool (``serve/pages/``) against the
JAX package's, and the engine's paged mode.

- Policy: the same operation sequences through the port's and JAX's
  ``PagePool`` / ``PrefixIndex`` give the same free lists, refcounts,
  LRU clocks, matches and evictions (exact); the JAX unit contracts
  (lifecycle, match caps, leaf-first LRU never touching a live page).
- Ops at float32: ``paged_decode_attention`` against the dense
  gather-and-softmax and against JAX's (rtol 1e-5, atol 1e-6; pages it
  must not visit hold NaN); ``prefill_partial_paged`` and
  ``decode_step_slots_paged`` against JAX's on cold, partially shared
  and fully shared admissions and three decode steps: logits rtol 1e-4,
  atol 1e-5 and the written pages alike (float32 summation order only),
  greedy tokens exact (the JAX package's own ``prefill_partial`` is not
  bitwise against its ``prefill``: ROADMAP.md Queue C). An inactive row
  and an out-of-range page id write nothing.
- Engine (``EngineConfig(paged=True)``): a cold / partially shared /
  fully shared mix streams exactly what the contiguous engine and
  ``generate()`` stream, with exact hit accounting; shared pages' bytes
  are unchanged by decode; references drop on retirement and on a crash
  drain; typed exhaustion mid-decode fails only the victim; admission
  back-pressure requeues and serves after a retirement; the same
  exhaustion under ``delay@op=page_admit`` (JAX's chaos case), and
  ``page_evict`` firing at an LRU eviction; worst-case
  submit rejection; ``prefix_share=False``; windowed models rejected;
  page metrics reach the logger; ``kv_dtype="q8"|"q4"`` builds the
  quantized pool (``tests/test_torch_kvq.py`` holds it to JAX's) and the
  contiguous engine refuses it.

Serial run time ~19 s.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, jax_and_port_lm, to_np
from distributed_pytorch_tpu.models import generate as jgen
from distributed_pytorch_tpu.ops import decode_attention as jda
from distributed_pytorch_tpu.serve import pages as jpages
from distributed_pytorch_tpu_torch import TransformerLM, generate
from distributed_pytorch_tpu_torch.models.generate import (
    decode_step_slots_paged, prefill_partial_paged)
from distributed_pytorch_tpu_torch.ops.decode_attention import (
    dense_decode_attention, paged_decode_attention)
from distributed_pytorch_tpu_torch.serve import (AdmissionRejected,
                                                 EngineConfig, EngineStopped,
                                                 InferenceEngine, PagePool,
                                                 PagePoolExhausted,
                                                 PrefixIndex,
                                                 SamplingParams, aggregate)
from distributed_pytorch_tpu_torch.serve.pages import PagedSlotPool
from distributed_pytorch_tpu_torch.utils.logging import MetricsLogger

MAX_LEN = 64
L = 8


def _lm1(**kw):
    kw = {**dict(vocab=61, dim=32, n_layers=1, n_heads=4, n_kv_heads=2,
                 pos="rope", max_seq=128), **kw}
    return TransformerLM(device=CPU, generator=torch.Generator()
                         .manual_seed(0), **kw)


def _paged(model, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("page_len", L)
    return InferenceEngine(model, EngineConfig(paged=True, **kw))


def _gen(model, prompt, n, max_len=None):
    return generate(model, prompt[None], n, max_len=max_len)[0].numpy()


# ---------------------------------------------------------------------------
# host policy: PagePool + PrefixIndex against the JAX ones
# ---------------------------------------------------------------------------

def _drive(pool_cls, index_cls, seed):
    """A seeded admission / release churn through one pool and index;
    returns everything they decided, step by step."""
    rng = np.random.default_rng(seed)
    pool, index = pool_cls(12, 4), index_cls(4)
    prefixes = [rng.integers(0, 9, 16).astype(np.int32) for _ in range(3)]
    owned, trace = [], []
    for _ in range(120):
        if owned and (rng.random() < 0.4 or len(owned) > 3):
            row = owned.pop(int(rng.integers(len(owned))))
            for pid in row:
                pool.decref(pid)
            trace.append(("release", tuple(row)))
        else:
            base = prefixes[int(rng.integers(3))]
            n = int(rng.integers(5, 15))
            toks = np.concatenate([base[:int(rng.integers(0, 16))],
                                   rng.integers(0, 9, n)]).astype(np.int32)
            s = len(toks)
            hits = index.match(toks, (s - 1) // 4, pool)
            for pid in hits:
                pool.incref(pid)
            fresh, evicted = [], []
            need = -(-s // 4) - len(hits)
            while len(fresh) < need:
                pid = pool.take_free()
                if pid is None:
                    pid = index.evict_lru(pool)
                    if pid is None:
                        break
                    evicted.append(pid)
                    pool.reclaim(pid)
                fresh.append(pid)
            if len(fresh) < need:
                for pid in fresh:
                    pool.release_to_free(pid)
                for pid in hits:
                    pool.decref(pid)
                trace.append(("exhausted", pool.exhausted(need).needed,
                              pool.exhausted(need).free_pages))
                continue
            row = hits + fresh
            added = index.insert(toks, s // 4, row, pool)
            owned.append(row)
            trace.append(("admit", tuple(hits), tuple(fresh),
                          tuple(evicted), added))
        trace.append((tuple(pool.refcount), tuple(pool.indexed),
                      tuple(pool._free), tuple(pool.last_used),
                      pool.evictions, pool.free_pages, pool.pages_in_use,
                      pool.live_pages(), len(index)))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_index_decide_as_jax(seed):
    got = _drive(PagePool, PrefixIndex, seed)
    want = _drive(jpages.PagePool, jpages.PrefixIndex, seed)
    assert got == want
    kinds = {t[0] for t in got if isinstance(t[0], str)}
    assert {"admit", "release"} <= kinds


def test_refcount_free_list_lifecycle():
    pool = PagePool(4, 8)
    a = pool.take_free()
    b = pool.take_free()
    assert pool.refcount[a] == 1 and pool.free_pages == 2
    pool.incref(a)
    pool.decref(a)
    assert pool.free_pages == 2
    pool.decref(a)
    assert pool.free_pages == 3
    with pytest.raises(ValueError, match="double release"):
        pool.decref(a)
    pool.indexed[b] = True
    pool.decref(b)
    assert pool.free_pages == 3 and pool.refcount[b] == 0


def test_match_caps_and_partial_pages_never_indexed():
    pool = PagePool(8, 4)
    idx = PrefixIndex(4)
    toks = np.arange(14, dtype=np.int32)
    pages = [pool.take_free() for _ in range(4)]
    idx.insert(toks, 14 // 4, pages, pool)
    assert len(idx) == 3 and not pool.indexed[pages[3]]
    assert idx.match(toks[:12], (12 - 1) // 4, pool) == pages[:2]
    assert idx.match(toks[:13], (13 - 1) // 4, pool) == pages[:3]
    other = toks.copy()
    other[5] += 1
    assert idx.match(other, 3, pool) == pages[:1]


def test_evict_lru_leaf_first_never_live():
    pool = PagePool(8, 4)
    idx = PrefixIndex(4)
    live = np.arange(8, dtype=np.int32)
    cold = np.arange(8, dtype=np.int32) + 20
    live_pages = [pool.take_free() for _ in range(2)]
    cold_pages = [pool.take_free() for _ in range(2)]
    idx.insert(live, 2, live_pages, pool)
    idx.insert(cold, 2, cold_pages, pool)
    for p in cold_pages:
        pool.decref(p)
    assert idx.evict_lru(pool) == cold_pages[1]
    assert idx.evict_lru(pool) == cold_pages[0]
    assert idx.evict_lru(pool) is None
    assert all(pool.refcount[p] == 1 for p in live_pages)
    assert pool.evictions == 2


# ---------------------------------------------------------------------------
# the paged ops against the dense path and JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_pages", [1, 2, 3])
def test_paged_decode_attention_matches_dense_and_jax(block_pages):
    rng = np.random.default_rng(0)
    b, h, hkv, dh, pl, n_pages, p = 3, 4, 2, 8, 4, 12, 5
    kp = rng.standard_normal((n_pages, hkv, pl, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, hkv, pl, dh)).astype(np.float32)
    tables = np.array([[3, 7, 1, 9, 0], [5, 2, 0, 0, 0], [8, 4, 6, 11, 0]],
                      np.int64)
    idx = np.array([13, 5, 10])
    hq = rng.standard_normal((b, h, 1, dh)).astype(np.float32)
    nk = rng.standard_normal((b, hkv, 1, dh)).astype(np.float32)
    nv = rng.standard_normal((b, hkv, 1, dh)).astype(np.float32)
    # pages no row visits (past every resident block) hold NaN
    kp[10], vp[10] = np.nan, np.nan
    scale = dh ** -0.5
    t = lambda a: torch.from_numpy(a)
    got = paged_decode_attention(t(hq), t(kp), t(vp), t(tables), t(idx),
                                 t(nk), t(nv), scale=scale, page_len=pl,
                                 block_pages=block_pages)
    assert torch.isfinite(got).all()
    # dense: gather every row's pages, lay this step's K/V over idx
    pos = np.arange(p * pl)
    k = kp[tables].transpose(0, 2, 1, 3, 4).reshape(b, hkv, p * pl, dh)
    v = vp[tables].transpose(0, 2, 1, 3, 4).reshape(b, hkv, p * pl, dh)
    wm = (pos[None, :] == idx[:, None])[:, None, :, None]
    k, v = np.where(wm, nk, k), np.where(wm, nv, v)
    dense = dense_decode_attention(t(hq), t(k), t(v),
                                   t(pos[None, :] <= idx[:, None]),
                                   scale=scale)
    np.testing.assert_allclose(to_np(got), to_np(dense), rtol=1e-5,
                               atol=1e-6)
    want = jda.paged_decode_attention(
        jnp.asarray(hq), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables, jnp.int32), jnp.asarray(idx, jnp.int32),
        jnp.asarray(nk), jnp.asarray(nv), scale=scale, page_len=pl)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_paged_prefill_and_decode_match_jax():
    """Cold, partially shared and fully shared admissions, then three
    decode steps of all three rows, against the JAX functions on the
    same weights and pools."""
    jm, params, pm = jax_and_port_lm(seed=1)
    pl, n_pages, p = 4, 16, 8
    dh = pm.dim // pm.n_heads
    shape = (n_pages, pm.n_kv_heads, pl, dh)
    jk = [jnp.zeros(shape) for _ in range(pm.n_layers)]
    jv = [jnp.zeros(shape) for _ in range(pm.n_layers)]
    tk = [torch.zeros(shape) for _ in range(pm.n_layers)]
    tv = [torch.zeros(shape) for _ in range(pm.n_layers)]
    rng = np.random.default_rng(3)
    base = rng.integers(0, 61, 11).astype(np.int32)
    other = np.concatenate([base[:8], rng.integers(0, 61, 5)]
                           ).astype(np.int32)
    tables = np.zeros((3, p), np.int64)
    # (prompt, table row, offset): cold; two shared pages + own tail;
    # the first two pages and a one-token tail
    cases = [(base, [0, 1, 2], 0), (other, [0, 1, 3, 4], 8),
             (base[:9], [0, 1, 5], 8)]
    lengths = np.zeros(3, np.int64)
    first = []
    for slot, (prompt, row, off) in enumerate(cases):
        tables[slot, :len(row)] = row
        tail = prompt[off:]
        padded = np.zeros((1, 16), np.int32)
        padded[0, :len(tail)] = tail
        jl, jk, jv = jgen.prefill_partial_paged(
            jm, params, jk, jv, jnp.asarray(tables[slot], jnp.int32),
            jnp.asarray(padded), off, len(tail), page_len=pl)
        tl, _, _ = prefill_partial_paged(pm, tk, tv, tables[slot],
                                         torch.from_numpy(padded), off,
                                         len(tail), page_len=pl)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5)
        first.append(int(np.argmax(np.asarray(jl))))
        assert int(tl.argmax()) == first[-1]
        lengths[slot] = len(prompt)
    for a, b in zip(tk + tv, jk + jv):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    tables[0, 3], tables[2, 3] = 6, 7      # pages for the decode writes
    tokens = np.asarray(first)
    active = np.array([True, True, True])
    for _ in range(3):
        jl, jk, jv = jgen.decode_step_slots_paged(
            jm, params, jk, jv, jnp.asarray(tables, jnp.int32),
            jnp.asarray(lengths, jnp.int32), jnp.asarray(tokens),
            jnp.asarray(active), page_len=pl)
        tl, _, _ = decode_step_slots_paged(pm, tk, tv, tables, lengths,
                                           torch.from_numpy(tokens), active,
                                           page_len=pl)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5)
        tokens = np.argmax(np.asarray(jl), axis=-1)
        assert (to_np(tl).argmax(-1) == tokens).all()
        lengths = lengths + active
        # the dense reference path computes the same step
    for a, b in zip(tk + tv, jk + jv):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    # inactive rows and an out-of-range page id write nothing; the
    # inactive rows still see their own key (the dense reference writes)
    tables[1, 4] = 8
    before = [x.clone() for x in tk]
    bad = tables.copy()
    bad[1, lengths[1] // pl] = n_pages + 3
    ref, _, _ = decode_step_slots_paged(pm, [x.clone() for x in tk],
                                        [x.clone() for x in tv], tables,
                                        lengths, torch.from_numpy(tokens),
                                        active, page_len=pl,
                                        blockwise=False)
    got, _, _ = decode_step_slots_paged(pm, tk, tv, bad, lengths,
                                        torch.from_numpy(tokens),
                                        np.array([False, True, False]),
                                        page_len=pl)
    for a, b in zip(before, tk):
        assert torch.equal(a, b)
    np.testing.assert_allclose(to_np(got)[[0, 2]], to_np(ref)[[0, 2]],
                               rtol=1e-5, atol=1e-6)
    # a quantized step needs the pool's scales and tails
    with pytest.raises(ValueError, match="k_scales"):
        decode_step_slots_paged(pm, tk, tv, tables, lengths,
                                torch.from_numpy(tokens), active,
                                page_len=pl, kv_bits=8)


def test_paged_decode_equals_contiguous_decode_bitwise():
    """The paged decode merges the contiguous decode's DECODE_BLOCK
    blocks, so the same K/V give the same logits, bit for bit."""
    from distributed_pytorch_tpu_torch.serve.cache import SlotPool
    model = _lm1(n_layers=2, max_seq=512)
    paged = PagedSlotPool(model, 2, 384, page_len=16, n_pages=48)
    contig = SlotPool(model, 2, 384)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 61, n).astype(np.int32) for n in (200, 130)]
    toks = torch.tensor([5, 9])
    with torch.inference_mode():
        for slot, p in enumerate(prompts):
            lp, _, _ = paged.admit(p, slot, (256,))
            padded = torch.zeros((1, 256), dtype=torch.long)
            padded[0, :len(p)] = torch.from_numpy(p.astype(np.int64))
            lc = contig.admit(padded, len(p), slot)
            assert torch.equal(lp, lc)
        for _ in range(4):
            for slot in range(2):
                paged.ensure_decode_capacity(slot)
            lp = paged.decode(toks, np.array([True, True]))
            lc = contig.decode(toks, np.array([True, True]))
            assert torch.equal(lp, lc)
            toks = lp.argmax(-1)


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------

def test_shared_mix_equals_contiguous_engine_and_generate():
    model = _lm1(n_layers=2)
    rng = np.random.default_rng(12)
    pfx = rng.integers(0, 61, (16,)).astype(np.int32)   # 2 full pages
    prompts = [np.concatenate([pfx, rng.integers(0, 61, (4,))]),
               np.concatenate([pfx, rng.integers(0, 61, (9,))]), None,
               rng.integers(0, 61, (5,)),
               np.concatenate([pfx[:8], rng.integers(0, 61, (6,))])]
    prompts[2] = prompts[0].copy()
    prompts = [p.astype(np.int32) for p in prompts]
    news = [12, 5, 8, 6, 6]
    outs = {}
    for paged in (False, True):
        eng = InferenceEngine(model, EngineConfig(
            n_slots=3, max_len=MAX_LEN, paged=paged, page_len=L))
        with eng:
            hs = [eng.submit(prompts[i], SamplingParams(max_new_tokens=news[i]))
                  for i in range(4)]
            hs[1].result(timeout=60)          # a slot frees mid-run
            hs.append(eng.submit(prompts[4],
                                 SamplingParams(max_new_tokens=news[4])))
            outs[paged] = [h.result(timeout=60) for h in hs]
    for i, (a, b) in enumerate(zip(outs[False], outs[True])):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
        np.testing.assert_array_equal(b, _gen(model, prompts[i], news[i]))
    assert [h.metrics["prefix_hit_pages"] for h in hs] == [0, 2, 2, 0, 1]
    assert [h.metrics["prefill_tokens_saved"] for h in hs] == [0, 16, 16,
                                                                0, 8]
    st = eng.stats()
    assert st["paged"] and st["pages"]["prefix_hit_pages"] == 5
    pool = eng.pool.pool
    # every request retired: no live reader, indexed pages resident
    assert pool.live_pages() == 0
    assert len(eng.pool.index) == pool.pages_in_use
    assert pool.free_pages + pool.pages_in_use == pool.n_pages


def test_shared_pages_unchanged_by_decode():
    model = _lm1()
    pool = PagedSlotPool(model, 2, MAX_LEN, page_len=L, n_pages=16)
    rng = np.random.default_rng(2)
    pfx = rng.integers(0, 61, 16).astype(np.int32)
    a = np.concatenate([pfx, rng.integers(0, 61, 3)]).astype(np.int32)
    b = np.concatenate([pfx, rng.integers(0, 61, 5)]).astype(np.int32)
    buckets = (8, 16, 32, 64)
    with torch.inference_mode():
        pool.admit(a, 0, buckets)
        _, n_hit, _ = pool.admit(b, 1, buckets)
        assert n_hit == 2
        shared = pool.owned[1][:2]
        assert shared == pool.owned[0][:2]
        assert pool.pool.refcount[shared[0]] == 2
        snap = [(k[shared].clone(), v[shared].clone())
                for k, v in zip(pool.k_pages, pool.v_pages)]
        tails = [pool.owned[s][2] for s in (0, 1)]
        tail_snap = pool.k_pages[0][tails].clone()
        for _ in range(8):
            for s in (0, 1):
                pool.ensure_decode_capacity(s)
            pool.decode(torch.tensor([3, 4]), np.array([True, True]))
    for (k0, v0), k, v in zip(snap, pool.k_pages, pool.v_pages):
        assert torch.equal(k0, k[shared]) and torch.equal(v0, v[shared])
    assert not torch.equal(tail_snap, pool.k_pages[0][tails])
    assert pool.lengths.tolist() == [27, 29]
    pool.release(0)
    pool.release(1)
    assert pool.pool.live_pages() == 0


def test_shared_tail_bucket_past_max_seq_learned_positions():
    """A prefix hit puts the padded tail at offset + bucket > max_seq:
    40 shared tokens (5 pages) plus a 17-token tail in the 32 bucket
    reach position 72 of a 64-row learned table. The pad rows are
    causally inert, so the stream is the contiguous engine's."""
    model = _lm1(n_layers=2, pos="learned", max_seq=MAX_LEN)
    rng = np.random.default_rng(13)
    pfx = rng.integers(0, 61, (40,))
    prompts = [np.concatenate([pfx, rng.integers(0, 61, (3,))]),
               np.concatenate([pfx, rng.integers(0, 61, (17,))])]
    prompts = [p.astype(np.int32) for p in prompts]
    sp = SamplingParams(max_new_tokens=6)
    outs = {}
    for paged in (False, True):
        eng = InferenceEngine(model, EngineConfig(
            n_slots=2, max_len=MAX_LEN, paged=paged, page_len=L))
        with eng:
            first = eng.submit(prompts[0], sp).result(timeout=60)
            h = eng.submit(prompts[1], sp)
            outs[paged] = [first, h.result(timeout=60)]
    assert h.metrics["prefix_hit_pages"] == 5
    assert 40 + 32 > model.max_seq
    for i, (a, b) in enumerate(zip(outs[False], outs[True])):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
        np.testing.assert_array_equal(b, _gen(model, prompts[i], 6))


def test_refcount_release_on_crash_drain():
    eng = _paged(_lm1(), n_slots=2)

    def boom(*a, **k):
        raise RuntimeError("injected engine bug")
    eng.pool.decode = boom
    eng.start()
    h = eng.submit(np.arange(10, dtype=np.int32),
                   SamplingParams(max_new_tokens=8))
    with pytest.raises(EngineStopped):
        h.result(timeout=60)
    eng.shutdown()
    assert eng.pool.pool.live_pages() == 0


def test_pool_exhaustion_mid_decode_fails_the_victim_only():
    model = _lm1()
    eng = _paged(model, n_slots=2, max_len=16, page_len=4, n_pages=4)
    rng = np.random.default_rng(8)
    a = rng.integers(0, 61, (4,)).astype(np.int32)    # 1 page
    b = rng.integers(0, 61, (8,)).astype(np.int32)    # 2 pages
    with eng:
        ha = eng.submit(a, SamplingParams(max_new_tokens=4))
        hb = eng.submit(b, SamplingParams(max_new_tokens=6))
        with pytest.raises(PagePoolExhausted) as ei:
            hb.result(timeout=60)
        out_a = ha.result(timeout=60)
    assert ei.value.request_id == hb.request_id
    assert ei.value.iteration is not None and ei.value.free_pages == 0
    np.testing.assert_array_equal(out_a, _gen(model, a, 4, max_len=16))
    assert hb.metrics["outcome"] == "no_free_pages"
    assert eng.pool.pool.live_pages() == 0


def test_chaos_page_admit_delay_with_exhaustion_mid_decode():
    """JAX's ``test_chaos_pool_exhaustion_mid_decode_typed_victim``: the
    same exhaustion under ``delay@op=page_admit,call=1,ms=1``; the
    page-op fault fired, the victim fails typed and alone, the other
    stream equals ``generate()``; and the LRU eviction hook fires
    ``page_evict`` when a refcount-zero page is reclaimed."""
    from distributed_pytorch_tpu_torch.runtime import faults
    faults.reset()
    try:
        faults.install("delay@op=page_admit,call=1,ms=1")
        model = _lm1()
        eng = _paged(model, n_slots=2, max_len=16, page_len=4, n_pages=4)
        rng = np.random.default_rng(8)
        a = rng.integers(0, 61, (4,)).astype(np.int32)
        b = rng.integers(0, 61, (8,)).astype(np.int32)
        with eng:
            ha = eng.submit(a, SamplingParams(max_new_tokens=4))
            hb = eng.submit(b, SamplingParams(max_new_tokens=6))
            with pytest.raises(PagePoolExhausted) as ei:
                hb.result(timeout=60)
            out_a = ha.result(timeout=60)
        assert ei.value.request_id == hb.request_id
        assert ei.value.iteration is not None and ei.value.free_pages == 0
        np.testing.assert_array_equal(out_a, _gen(model, a, 4, max_len=16))
        assert faults.fired() == ["delay@op=page_admit,call=1"]
        assert eng.pool.pool.live_pages() == 0
        faults.install("delay@op=page_evict,ms=1")
        pool, index = PagePool(4, 4), PrefixIndex(4)
        pages = [pool.take_free() for _ in range(2)]
        index.insert(np.arange(8, dtype=np.int32), 2, pages, pool)
        for pid in pages:
            pool.decref(pid)
        assert index.evict_lru(pool) == pages[1]
        assert faults.fired()[-1] == "delay@op=page_evict,call=1"
    finally:
        faults.reset()


def test_admission_backpressure_requeues_then_serves():
    model = _lm1()
    eng = _paged(model, n_slots=2, max_len=12, page_len=4, n_pages=3)
    rng = np.random.default_rng(9)
    a = rng.integers(0, 61, (8,)).astype(np.int32)
    b = rng.integers(0, 61, (8,)).astype(np.int32)
    sp = SamplingParams(max_new_tokens=4)
    with eng:
        ha = eng.submit(a, sp)
        hb = eng.submit(b, sp)
        out_a, out_b = ha.result(timeout=60), hb.result(timeout=60)
    np.testing.assert_array_equal(out_a, _gen(model, a, 4, max_len=12))
    np.testing.assert_array_equal(out_b, _gen(model, b, 4, max_len=12))
    assert hb.metrics["admit_iteration"] >= ha.metrics["retire_iteration"]
    assert eng.pool.pool.evictions > 0


def test_submit_rejects_worst_case_page_need():
    eng = _paged(_lm1(), n_slots=1, max_len=32, page_len=4, n_pages=2)
    with pytest.raises(AdmissionRejected) as ei:
        eng.submit(np.arange(10, dtype=np.int32),
                   SamplingParams(max_new_tokens=10))
    assert ei.value.reason == "no_free_pages"
    eng.shutdown(wait=False)


def test_prefix_share_off_still_exact(monkeypatch):
    model = _lm1()
    monkeypatch.setenv("DPX_SERVE_PREFIX_SHARE", "0")
    monkeypatch.setenv("DPX_SERVE_PAGE_LEN", "4")
    prompt = np.random.default_rng(10).integers(0, 61, 18).astype(np.int32)
    eng = InferenceEngine(model, EngineConfig(n_slots=2, max_len=MAX_LEN,
                                              paged=True))
    assert eng.pool.page_len == 4 and not eng.pool.prefix_share
    assert eng.pool.n_pages == 2 * MAX_LEN // 4
    with eng:
        hs = [eng.submit(prompt, SamplingParams(max_new_tokens=6))
              for _ in range(2)]
        outs = [h.result(timeout=60) for h in hs]
    for out, h in zip(outs, hs):
        np.testing.assert_array_equal(out, _gen(model, prompt, 6))
        assert h.metrics["prefix_hit_pages"] == 0
    assert len(eng.pool.index) == 0


def test_windowed_model_rejects_paged():
    from distributed_pytorch_tpu_torch.ops.flash_attention import \
        make_flash_attn_fn
    model = _lm1(attn_fn=make_flash_attn_fn(window=8))
    with pytest.raises(ValueError, match="sliding-window"):
        _paged(model)


def test_paged_metrics_flow_to_logger(tmp_path):
    model = _lm1()
    log = tmp_path / "serve_pages.jsonl"
    logger = MetricsLogger(path=str(log))
    eng = InferenceEngine(model, EngineConfig(
        n_slots=2, max_len=MAX_LEN, paged=True, page_len=L,
        metrics=logger, log_every=2))
    rng = np.random.default_rng(11)
    pfx = rng.integers(0, 61, (16,)).astype(np.int32)
    with eng:
        hs = [eng.submit(np.concatenate([pfx, rng.integers(0, 61, (3,))])
                         .astype(np.int32), SamplingParams(max_new_tokens=6))
              for _ in range(3)]
        for h in hs:
            h.result(timeout=60)
    logger.close()
    rows = [json.loads(x) for x in log.read_text().splitlines()]
    reqs = [r for r in rows if r.get("event") == "serve_request"]
    assert sorted(r["prefix_hit_pages"] for r in reqs) == [0, 2, 2]
    assert sorted(r["prefill_tokens_saved"] for r in reqs) == [0, 16, 16]
    snaps = [r for r in rows if r.get("event") == "metrics_snapshot"
             and r.get("source") == "serve_engine"]
    assert snaps
    for r in snaps:
        m = r["metrics"]
        assert 0.0 <= m["serve.pool_occupancy"] <= 1.0
        assert {"serve.free_pages", "serve.page_evictions",
                "serve.kv_pool_bytes"} <= set(m)
    agg = aggregate([h.metrics for h in hs])
    assert agg["prefill_tokens_saved"] == 32
    assert agg["prefix_hit_pages"] == 4
    assert 0.0 < agg["prefix_hit_rate"] < 1.0
    ps = eng.stats()["pages"]
    assert ps["kv_bits"] == 32
    assert ps["kv_pool_bytes"] == 2 * 1 * ps["n_pages"] * 2 * L * 8 * 4
    assert ps["bytes_per_resident_token"] == ps["kv_pool_bytes"] / (
        ps["n_pages"] * L)


@pytest.mark.parametrize("kv_dtype", ["q8", "q4"])
def test_quantized_kv_raises_naming_the_item(kv_dtype, monkeypatch):
    """Quantized pages are ported: an explicit or env-driven q8/q4 builds
    the quantized paged pool; only the contiguous engine still refuses
    an explicit one, naming the paged pool."""
    model = _lm1()
    bits = {"q8": 8, "q4": 4}[kv_dtype]
    assert _paged(model, kv_dtype=kv_dtype).stats()["pages"]["kv_bits"] \
        == bits
    monkeypatch.setenv("DPX_SERVE_KV_DTYPE", kv_dtype)
    assert _paged(model).pool.quant_bits == bits
    with pytest.raises(ValueError, match="paged=True"):
        InferenceEngine(model, EngineConfig(kv_dtype=kv_dtype))
