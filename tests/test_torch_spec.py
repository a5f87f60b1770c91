"""The port's speculative decoding (``serve/spec/``) and tenant quota
against the JAX package's.

- ``accept_greedy``: its four cases (full acceptance emits k+1, the
  first mismatch truncates, the budget caps, eos truncates inclusive),
  equal to the JAX package's rule on the same inputs.
- Verify and commit at float32 (2 layers, dim 64, 4 heads, page 8):
  ``spec_verify_slots`` and ``spec_verify_slots_paged`` (exact, q8 and
  q4 pages with tails) against the JAX functions on converted weights
  and the same pool state, logits atol 1e-5 and the candidate K/V alike;
  ``spec_commit_slots[_paged]`` write what the JAX functions write
  (pools, scales and tails equal), a commit crossing a page boundary
  quantizing the page it completes.
- Engine: greedy streams with ``spec_decode=True`` equal the port's
  ``generate()`` on the contiguous, the paged and the q8 pool (whose
  unspeculated streams equal ``generate()``'s on this model); a
  self-draft accepts everything
  (rate 1.0, k+1 tokens an iteration), a zero draft nothing and an
  unrelated draft little; ``draft_len`` beyond the remaining budget;
  spec and sampled requests in one batch; the tenant quota rejects,
  then releases; construction errors.
- A rejection at a page boundary leaves the next page unallocated and
  unquantized, and an accepted token on a fresh page sits exact in the
  tail (the port's own test of the contract whose JAX test fails in this
  container: ROADMAP.md Queue C).

Serial run time ~20 s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, jax_and_port_lm, to_np
from distributed_pytorch_tpu.models import generate as jgen
from distributed_pytorch_tpu.serve.spec import accept_greedy as jaccept
from distributed_pytorch_tpu_torch import TransformerLM, generate
from distributed_pytorch_tpu_torch.models.generate import (
    spec_commit_slots, spec_commit_slots_paged, spec_verify_slots,
    spec_verify_slots_paged)
from distributed_pytorch_tpu_torch.nn.attention import dense_attention
from distributed_pytorch_tpu_torch.ops import quant
from distributed_pytorch_tpu_torch.serve import (AdmissionRejected,
                                                 EngineConfig,
                                                 InferenceEngine,
                                                 SamplingParams,
                                                 SpecConfig, SpecState,
                                                 accept_greedy, aggregate)
from distributed_pytorch_tpu_torch.serve.pages import PagedSlotPool

MAX_LEN = 64
BUCKETS = (8, 16, 32)
L = 8


def _lm(seed=0, **kw):
    kw = {**dict(vocab=61, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 pos="rope", max_seq=128), **kw}
    return TransformerLM(device=CPU, generator=torch.Generator()
                         .manual_seed(seed), **kw)


def _draft(seed=1):
    """The cheap proposer: the same vocabulary, a fraction of the
    stack."""
    return _lm(seed, dim=32, n_layers=1, n_heads=2, n_kv_heads=1)


def _spec_cfg(draft, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("draft_len", 3)
    return EngineConfig(spec_decode=True, draft_model=draft, **kw)


def _prompts():
    """Cold and shared-prefix prompts: the last two share their first 8
    tokens (one full page)."""
    base = np.arange(1, 25, dtype=np.int32) % 61
    return [base[:5].copy(), base[:13].copy(),
            np.concatenate([base[:8], base[8:11] * 0 + 7]),
            np.concatenate([base[:8], base[8:12] * 0 + 9])]


def _gen(model, prompt, n):
    return generate(model, prompt[None], n)[0].numpy()


def _serve(model, cfg, prompts, sps, **submit_kw):
    eng = InferenceEngine(model, cfg)
    with eng:
        hs = [eng.submit(p, sp, **submit_kw) for p, sp in zip(prompts, sps)]
        outs = [h.result(timeout=120) for h in hs]
    return eng, hs, outs


# ---------------------------------------------------------------------------
# the acceptance rule (pure host code)
# ---------------------------------------------------------------------------

def _logits(g, vocab=16):
    """Verify logits whose per-position argmax is ``g``."""
    lg = np.zeros((len(g), vocab), np.float32)
    lg[np.arange(len(g)), g] = 1.0
    return lg


G = np.array([3, 5, 7, 9], np.int32)          # k = 3


@pytest.mark.parametrize("drafts,remaining,eos,want", [
    (G[:3], 10, None, [3, 5, 7, 9]),            # full: the bonus rides free
    (np.array([3, 6, 7]), 10, None, [3, 5]),    # d_2 wrong
    (G[:3], 2, None, [3, 5]),                   # the budget caps
    (G[:3], 10, 5, [3, 5]),                     # eos kept, suffix cut
], ids=["full", "first_mismatch", "remaining", "eos"])
def test_accept_greedy_cases(drafts, remaining, eos, want):
    out, e = accept_greedy(drafts, _logits(G), remaining, eos)
    assert out == want and e == len(want)
    assert (out, e) == jaccept(np.asarray(drafts, np.int32), _logits(G),
                               remaining, eos)


# ---------------------------------------------------------------------------
# verify and commit against the JAX functions
# ---------------------------------------------------------------------------

def _jnp(a):
    return jnp.asarray(np.array(a, copy=True))


def test_verify_and_commit_contiguous_match_jax():
    jm, params, pm = jax_and_port_lm(seed=3, dim=64)
    rng = np.random.default_rng(0)
    b, w, s = 3, 40, 4
    dh = pm.dim // pm.n_heads
    shape = (b, pm.n_kv_heads, w, dh)
    ks = [rng.standard_normal(shape).astype(np.float32)
          for _ in range(pm.n_layers)]
    vs = [rng.standard_normal(shape).astype(np.float32)
          for _ in range(pm.n_layers)]
    lengths = np.array([5, 17, 36])
    tokens = rng.integers(0, 61, (b, s)).astype(np.int32)
    jl, jsk, jsv = jgen.spec_verify_slots(
        jm, params, [_jnp(a) for a in ks], [_jnp(a) for a in vs],
        jnp.asarray(lengths, jnp.int32), jnp.asarray(tokens))
    tks = [torch.from_numpy(a.copy()) for a in ks]
    tvs = [torch.from_numpy(a.copy()) for a in vs]
    with torch.inference_mode():
        tl, tsk, tsv = spec_verify_slots(pm, tks, tvs, lengths,
                                         torch.from_numpy(tokens))
    assert tl.shape == (b, s, 61)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for a, c in zip(tsk + tsv, jsk + jsv):
        np.testing.assert_allclose(to_np(a), np.asarray(c), rtol=1e-5,
                                   atol=1e-5)
    # read-only: the pool is unchanged
    for a, c in zip(tks + tvs, ks + vs):
        assert np.array_equal(a.numpy(), c)
    commit = np.array([0, 4, 2])
    jk, jv, jlen = jgen.spec_commit_slots(
        [_jnp(a) for a in ks], [_jnp(a) for a in vs],
        jnp.asarray(lengths, jnp.int32), jsk, jsv,
        jnp.asarray(commit, jnp.int32))
    sk = [torch.from_numpy(np.array(a)) for a in jsk]
    sv = [torch.from_numpy(np.array(a)) for a in jsv]
    _, _, new_len = spec_commit_slots(tks, tvs, lengths, sk, sv, commit)
    assert np.array_equal(new_len, np.asarray(jlen))
    for a, c in zip(tks + tvs, jk + jv):
        assert np.array_equal(a.numpy(), np.asarray(c))


def _pages(rng, n_layers, n_pages, hkv, pl, dh, bits):
    """Random pool state: exact pages, or quantized pages with their
    scales and random f32 tails (numpy, the JAX layout)."""
    exact = [rng.standard_normal((n_pages, hkv, pl, dh)).astype(np.float32)
             for _ in range(2 * n_layers)]
    if bits is None:
        return exact[:n_layers], exact[n_layers:], {}
    qs, ss = [], []
    for e in exact:
        q, sc = quant.quantize_page_blocks(torch.from_numpy(e), bits)
        qs.append((quant.pack_page_nibbles(q) if bits == 4 else q).numpy())
        ss.append(sc.numpy())
    tails = [rng.standard_normal((3, hkv, pl, dh)).astype(np.float32)
             for _ in range(2 * n_layers)]
    return qs[:n_layers], qs[n_layers:], dict(
        kv_bits=bits, k_scales=ss[:n_layers], v_scales=ss[n_layers:],
        k_tail=tails[:n_layers], v_tail=tails[n_layers:])


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["f32", "q8", "q4"])
def test_verify_and_commit_paged_match_jax(bits):
    jm, params, pm = jax_and_port_lm(seed=4, dim=64)
    rng = np.random.default_rng(1)
    dh = pm.dim // pm.n_heads
    n_pages, p, s = 20, 5, 4
    kp, vp, qkw = _pages(rng, pm.n_layers, n_pages, pm.n_kv_heads, L, dh,
                         bits)
    tables = np.array([[3, 7, 1, 9, 0], [5, 2, 11, 0, 0],
                       [8, 4, 6, 12, 13]], np.int64)
    lengths = np.array([14, 6, 29])
    tokens = rng.integers(0, 61, (3, s)).astype(np.int32)

    def jax_kw():
        return {k: (v if k == "kv_bits" else [_jnp(a) for a in v])
                for k, v in qkw.items()}

    def port_kw():
        return {k: (v if k == "kv_bits"
                    else [torch.from_numpy(a.copy()) for a in v])
                for k, v in qkw.items()}
    jl, jsk, jsv = jgen.spec_verify_slots_paged(
        jm, params, [_jnp(a) for a in kp], [_jnp(a) for a in vp],
        jnp.asarray(tables, jnp.int32), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(tokens), page_len=L, **jax_kw())
    tkw = port_kw()
    tkp = [torch.from_numpy(a.copy()) for a in kp]
    tvp = [torch.from_numpy(a.copy()) for a in vp]
    with torch.inference_mode():
        tl, tsk, tsv = spec_verify_slots_paged(
            pm, tkp, tvp, tables, lengths, torch.from_numpy(tokens),
            page_len=L, **tkw)
    # in a quantized pool a candidate past the end of its page reads that
    # page quantized, as the decode does; the JAX verify reads it exact
    # (ROADMAP.md Queue C), so those candidates are held to the port's
    # decode instead (test_quantized_verify_equals_sequential_decode)
    same = np.ones((3, s), bool)
    if bits is not None:
        pos = lengths[:, None] + np.arange(s)[None, :]
        same = pos // L == (lengths // L)[:, None]
        assert not same.all()
    np.testing.assert_allclose(to_np(tl)[same], np.asarray(jl)[same],
                               rtol=1e-5, atol=1e-5)
    for i, (a, c) in enumerate(zip(tsk + tsv, jsk + jsv)):
        # the first layer's K/V come before any attention
        sel = same if i % pm.n_layers else np.ones_like(same)
        np.testing.assert_allclose(to_np(a).transpose(0, 2, 1, 3)[sel],
                                   np.asarray(c).transpose(0, 2, 1, 3)[sel],
                                   rtol=1e-5, atol=1e-5)
    for a, c in zip(tkp + tvp, kp + vp):
        assert np.array_equal(a.numpy(), c)
    # row 1 completes its page 5 (positions 6, 7) and starts page 2; row
    # 2 completes page 12 at position 31 and goes on into page 13
    commit = np.array([0, 3, 4])
    out = jgen.spec_commit_slots_paged(
        [_jnp(a) for a in kp], [_jnp(a) for a in vp],
        jnp.asarray(tables, jnp.int32), jnp.asarray(lengths, jnp.int32),
        jsk, jsv, jnp.asarray(commit, jnp.int32), page_len=L, **jax_kw())
    sk = [torch.from_numpy(np.array(a)) for a in jsk]
    sv = [torch.from_numpy(np.array(a)) for a in jsv]
    got = spec_commit_slots_paged(tkp, tvp, tables, lengths, sk, sv, commit,
                                  page_len=L, **tkw)
    assert len(got) == len(out) == (2 if bits is None else 6)
    for tp, jp in zip(got, out):
        for a, c in zip(tp, jp):
            assert np.array_equal(a.numpy(), np.asarray(c))
    if bits is not None:
        # the two completed pages carry fresh scales
        assert not np.array_equal(got[2][0][5].numpy(), qkw["k_scales"][0][5])
        assert not np.array_equal(got[2][0][12].numpy(),
                                  qkw["k_scales"][0][12])


@pytest.mark.parametrize("kv_dtype", ["f32", "q8", "q4"])
def test_verify_equals_sequential_decode_across_a_page(kv_dtype):
    """A verify's row j gives the logits of the decode step at its
    position, across a page boundary too: there the decode reads the
    completed page quantized, and so does the verify."""
    model = _lm()
    prompts = [np.arange(1, 7, dtype=np.int32), np.arange(3, 16,
                                                          dtype=np.int32)]

    def pool():
        p = PagedSlotPool(model, 2, MAX_LEN, page_len=L, n_pages=16,
                          kv_dtype=kv_dtype)
        first = torch.cat([p.admit(x, slot, BUCKETS)[0]
                           for slot, x in enumerate(prompts)])
        return p, first.argmax(-1)
    with torch.inference_mode():
        seq, cur = pool()
        toks, want = [cur], []
        for _ in range(5):
            for slot in range(2):
                seq.ensure_decode_capacity(slot)
            lg = seq.decode(toks[-1], np.array([True, True]))
            want.append(lg)
            toks.append(lg.argmax(-1))
        ver, _ = pool()
        got = ver.spec_verify(torch.stack(toks[:5], 1))[0]
    # rows 0 and 1 cross pages 0 -> 1 at positions 8 and 16
    for j in range(5):
        np.testing.assert_allclose(to_np(got[:, j]), to_np(want[j]),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine: greedy streams, acceptance extremes, rollback edges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool_kw", [
    {}, {"paged": True, "page_len": L},
    {"paged": True, "page_len": L, "kv_dtype": "q8"},
], ids=["contiguous", "paged", "q8"])
def test_spec_streams_equal_the_reference(pool_kw):
    """Speculation changes no greedy stream: on exact pools the streams
    are ``generate()``'s, on the q8 pool the same engine's unspeculated
    ones; the per-request accounting reaches the records."""
    model, draft = _lm(), _draft()
    prompts = _prompts()
    n = 12
    sps = [SamplingParams(max_new_tokens=n)] * len(prompts)
    refs = [_gen(model, p, n) for p in prompts]
    if pool_kw.get("kv_dtype"):
        # on this model the q8 pool keeps generate()'s streams; the
        # contract is the unspeculated engine's, which the card checks
        q8 = _serve(model, EngineConfig(n_slots=4, max_len=MAX_LEN,
                                        buckets=BUCKETS, **pool_kw),
                    prompts, sps)[2]
        for a, b in zip(q8, refs):
            np.testing.assert_array_equal(a, b)
    eng, hs, outs = _serve(model, _spec_cfg(draft, **pool_kw), prompts, sps,
                           tenant="acme")
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, ref)
    st = eng.stats()
    assert st["spec_decode"] is True
    sp = st["spec"]
    assert sp["proposed"] > 0 and sp["verify_steps"] > 0
    recs = [h.metrics for h in hs]
    assert all(r["tenant"] == "acme" for r in recs)
    assert sum(r["spec_proposed"] for r in recs) == sp["proposed"]
    assert sum(r["spec_accepted"] for r in recs) == sp["accepted"]
    agg = aggregate(recs)
    assert agg["spec_proposed"] == sp["proposed"]
    assert 0.0 <= agg["spec_acceptance_rate"] <= 1.0


@pytest.mark.parametrize("paged", [False, True])
def test_self_draft_accepts_everything(paged):
    """The target as its own draft on exact pools: every proposal
    matches, the rate is exactly 1.0 and every iteration commits k+1
    tokens (max_new = 1 + 3 (k+1): no iteration is cut by the budget)."""
    model = _lm()
    prompts = _prompts()[:2]
    n = 13
    kw = {"paged": True, "page_len": L} if paged else {}
    eng, _, outs = _serve(model, _spec_cfg(model, n_slots=2, **kw), prompts,
                          [SamplingParams(max_new_tokens=n)] * 2)
    for out, p in zip(outs, prompts):
        np.testing.assert_array_equal(out, _gen(model, p, n))
    st = eng.stats()["spec"]
    assert st["acceptance_rate"] == 1.0
    assert st["tokens_per_iteration"] == 4.0


def test_zero_and_unrelated_drafts_accept_nothing_or_little():
    """A zero draft proposes token 0 forever; the target's stream holds
    no 0, so the rate is exactly 0.0 and each iteration commits one
    token; a draft of another seed accepts little. Both streams stay
    ``generate()``'s."""
    model = _lm()
    prompts = _prompts()[:2]
    n = 13
    refs = [_gen(model, p, n) for p in prompts]
    for r in refs:
        assert not (r == 0).any()                 # precondition
    zero = _draft()
    with torch.no_grad():
        for prm in zero.parameters():
            prm.zero_()
    for draft, check in ((zero, lambda st: st["acceptance_rate"] == 0.0
                          and st["tokens_per_iteration"] == 1.0),
                         (_draft(seed=7), lambda st:
                          st["acceptance_rate"] < 0.25)):
        eng, _, outs = _serve(model, _spec_cfg(draft, n_slots=2), prompts,
                              [SamplingParams(max_new_tokens=n)] * 2)
        for out, ref in zip(outs, refs):
            np.testing.assert_array_equal(out, ref)
        assert check(eng.stats()["spec"]), eng.stats()["spec"]


def test_page_boundary_rejection_leaves_the_page_unquantized():
    """q8 pool: acceptance that ends exactly at a page boundary
    quantizes that page, from accepted tokens, and leaves the next page
    unallocated; a later commit of one token into a fresh page leaves it
    in the exact tail with its scales untouched."""
    model = _lm(n_layers=1)
    pool = PagedSlotPool(model, 1, MAX_LEN, page_len=L, n_pages=8,
                         kv_dtype="q8")
    prompt = np.arange(1, 7, dtype=np.int32)          # 6 tokens
    with torch.inference_mode():
        pool.admit(prompt, 0, BUCKETS)
        pid0 = pool.owned[0][0]
        ones = torch.ones_like(pool.k_scales[0][pid0])
        assert torch.equal(pool.k_scales[0][pid0], ones)
        toks = torch.tensor([[2, 3, 4, 5]])
        _, sk, sv = pool.spec_verify(toks)
        # accept 2 of 4: positions 6 and 7 end the page; the drafts for
        # positions 8 and 9 are rejected
        pool.ensure_spec_capacity(0, 2)
        pool.spec_commit(sk, sv, np.array([2]))
        assert int(pool.lengths[0]) == 8
        assert not torch.equal(pool.k_scales[0][pid0], ones)
        assert len(pool.owned[0]) == 1               # page 1 never asked for
        # the completed page: its accepted positions within scale/2
        bmap = quant.page_block_map(model.n_kv_heads, L, 16)
        deq = quant.dequantize_page_blocks(pool.k_pages[0][pid0][None],
                                           pool.k_scales[0][pid0][None],
                                           bmap)[0]
        half = pool.k_scales[0][pid0][bmap] / 2
        err = (deq[:, 6:8] - sk[0][0, :, :2]).abs()
        assert (err <= half[:, 6:8] * (1 + 1e-6)).all()
        # next iteration: accept one token into a fresh page
        _, sk, sv = pool.spec_verify(toks)
        pool.ensure_spec_capacity(0, 1)
        pool.spec_commit(sk, sv, np.array([1]))
        assert int(pool.lengths[0]) == 9
        pid1 = pool.owned[0][1]
        assert torch.equal(pool.k_scales[0][pid1], ones)
        assert not pool.k_pages[0][pid1].any()
        assert torch.equal(pool.k_tail[0][0, :, 0], sk[0][0, :, 0])
        assert torch.equal(pool.v_tail[0][0, :, 0], sv[0][0, :, 0])


def test_draft_len_longer_than_remaining():
    """k = 6 against max_new = 3: acceptance is capped by the budget every
    iteration, the stream is exact and the request retires at max_new."""
    model, draft = _lm(n_layers=1), _draft()
    prompt = _prompts()[0]
    n = 3
    eng, _, (out,) = _serve(model, _spec_cfg(draft, n_slots=2, draft_len=6),
                            [prompt], [SamplingParams(max_new_tokens=n)])
    np.testing.assert_array_equal(out, _gen(model, prompt, n))
    assert len(out) == n
    assert eng.stats()["spec"]["proposed"] % 6 == 0


def test_mixed_spec_and_sampled_batch():
    """Greedy (speculating) and sampled (not) requests share the batch:
    the sampled stream is its standalone ``generate()`` stream with a
    generator in the same state."""
    model, draft = _lm(), _draft()
    prompts = _prompts()
    n = 10
    sp_s = SamplingParams(max_new_tokens=n, temperature=0.7, top_k=8)
    ref_s = generate(model, prompts[1][None], n, temperature=0.7, top_k=8,
                     generator=torch.Generator().manual_seed(5))[0].numpy()
    eng = InferenceEngine(model, _spec_cfg(draft))
    with eng:
        hg = eng.submit(prompts[0], SamplingParams(max_new_tokens=n))
        hs = eng.submit(prompts[1], sp_s,
                        generator=torch.Generator().manual_seed(5))
        out_g, out_s = hg.result(timeout=120), hs.result(timeout=120)
    np.testing.assert_array_equal(out_g, _gen(model, prompts[0], n))
    np.testing.assert_array_equal(out_s, ref_s)
    assert eng.stats()["spec"]["proposed"] > 0
    assert hs.metrics["spec_proposed"] == 0


# ---------------------------------------------------------------------------
# the tenant quota, construction errors
# ---------------------------------------------------------------------------

def test_tenant_quota_rejects_then_releases(monkeypatch):
    monkeypatch.setenv("DPX_SERVE_TENANT_MAX_INFLIGHT", "1")
    model = _lm(n_layers=1)
    eng = InferenceEngine(model, EngineConfig(n_slots=2, max_len=MAX_LEN,
                                              buckets=BUCKETS))
    prompt = _prompts()[0]
    eng.start()
    try:
        h1 = eng.submit(prompt, SamplingParams(max_new_tokens=24),
                        tenant="t0")
        with pytest.raises(AdmissionRejected) as ei:
            eng.submit(prompt, SamplingParams(max_new_tokens=4),
                       tenant="t0")
        assert ei.value.reason == "tenant_quota"
        assert ei.value.tenant == "t0"
        # another tenant is not throttled by t0's quota
        h2 = eng.submit(prompt, SamplingParams(max_new_tokens=4),
                        tenant="t1")
        h1.result(timeout=120)
        h2.result(timeout=120)
        # the credit came back at retirement
        h3 = eng.submit(prompt, SamplingParams(max_new_tokens=4),
                        tenant="t0")
        assert h3.result(timeout=120).shape == (4,)
        assert h3.metrics["tenant"] == "t0"
    finally:
        eng.shutdown()
    assert eng._tenant_inflight == {}


def test_construction_errors(monkeypatch):
    model = _lm(n_layers=1)
    with pytest.raises(ValueError, match="draft_model"):
        InferenceEngine(model, EngineConfig(spec_decode=True))
    monkeypatch.setenv("DPX_SPEC_DECODE", "1")
    with pytest.raises(ValueError, match="draft_model"):
        InferenceEngine(model, EngineConfig())
    monkeypatch.delenv("DPX_SPEC_DECODE")
    with pytest.raises(ValueError, match="draft_len"):
        InferenceEngine(model, _spec_cfg(_draft(), draft_len=0))
    with pytest.raises(ValueError, match="draft_len"):
        SpecState(SpecConfig(draft_model=_draft(), draft_len=0), 2, MAX_LEN)

    def windowed(q, k, v, *, causal=False, scale=None):
        return dense_attention(q, k, v, causal=causal, scale=scale, window=8)
    windowed.window = 8
    wmodel = _lm(n_layers=1, attn_fn=windowed)
    with pytest.raises(ValueError, match="sliding-window"):
        InferenceEngine(wmodel, _spec_cfg(_draft()))
    monkeypatch.setenv("DPX_SPEC_DRAFT_LEN", "5")
    eng = InferenceEngine(model, EngineConfig(spec_decode=True,
                                              draft_model=_draft()))
    assert eng.stats()["spec"]["draft_len"] == 5
