"""The port's quantized KV pages (``kv_dtype="q8"|"q4"``) against the
JAX package's.

- Codecs: the port's numpy ``comm/wire`` copy and its tensor page codec
  (``ops/quant``) are bit-identical to the JAX package's ``comm/wire``
  and ``ops/quant`` at q8 and q4, over random, all-zero, small-integer
  and ragged blocks and multi-block pages; nibble packing is
  byte-identical to ``wire.pack_nibbles`` over all 15 nibble values in
  both positions, and unpacking round-trips; every dequantized element
  is within scale/2 of its value.
- ``resolve_kv_bits``; an odd head dim rejects q4.
- Ops at float32 (2 layers, dim 64, 4 heads, page 8, and a 2-block page
  of 32): the quantized ``paged_decode_attention``,
  ``prefill_partial_paged`` and ``decode_step_slots_paged`` against the
  JAX functions on converted weights, cold, partially shared and fully
  shared admissions and four decode steps crossing a page boundary:
  logits atol 1e-5, pools, scales and tails equal (exact, or atol 1e-5
  where an f32 summation order rounds a quantized value's source).
  The JAX functions get fresh numpy copies of the pool state (the JAX
  ``PagedSlotPool`` aliases its host tables: ROADMAP.md Queue C).
- ``kv_dtype="f32"`` keeps the exact pool of the previous slice: pages
  in the model dtype, no scales or tails, logits and pages bit for bit
  those of the contiguous pool.
- Pool: cold first logits exact at q8/q4; the per-element scale/2 bound
  on a cold prefill's pages; capacity arithmetic; engine config errors.

Serial run time ~60 s (most of it JAX compiling).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, jax_and_port_lm, to_np
from distributed_pytorch_tpu.comm import wire as jwire
from distributed_pytorch_tpu.models import generate as jgen
from distributed_pytorch_tpu.ops import decode_attention as jda
from distributed_pytorch_tpu.ops import quant as jquant
from distributed_pytorch_tpu.serve.pages import quant as jpq
from distributed_pytorch_tpu_torch import TransformerLM
from distributed_pytorch_tpu_torch.comm import wire
from distributed_pytorch_tpu_torch.models.generate import (
    decode_step_slots_paged, prefill_partial_paged)
from distributed_pytorch_tpu_torch.ops import quant
from distributed_pytorch_tpu_torch.ops.decode_attention import \
    paged_decode_attention
from distributed_pytorch_tpu_torch.serve import (EngineConfig,
                                                 InferenceEngine,
                                                 SamplingParams)
from distributed_pytorch_tpu_torch.serve.cache import SlotPool
from distributed_pytorch_tpu_torch.serve.pages import PagedSlotPool
from distributed_pytorch_tpu_torch.serve.pages import quant as pq

BITS = [8, 4]


def _blocks(rng, n):
    """A flat f32 payload of ragged length with a random block, an
    all-zero block, a small-integer block and a large-integer block."""
    b = wire.QUANT_BLOCK
    x = rng.standard_normal(n).astype(np.float32) * 3
    x[b:2 * b] = 0.0
    x[2 * b:3 * b] = rng.integers(-5, 6, b)
    x[3 * b:4 * b] = rng.integers(-500, 500, b)
    return x


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
def test_wire_codec_bit_identical_to_jax(bits):
    rng = np.random.default_rng(bits)
    x = _blocks(rng, 4 * wire.QUANT_BLOCK + 333)
    q, s = wire.quantize_blocks(x, bits=bits)
    jq, js = jwire.quantize_blocks(x, bits=bits)
    assert q.dtype == np.int8 and np.array_equal(q, jq)
    assert s.dtype == np.float32 and np.array_equal(s, js)
    assert np.array_equal(wire.dequantize_blocks(q, s),
                          jwire.dequantize_blocks(jq, js))
    assert wire.num_blocks(x.size) == jwire.num_blocks(x.size) == 5
    assert wire.quant_levels(bits) == jwire.quant_levels(bits)
    # the integer snap: exact round trip of the small-integer block
    b = wire.QUANT_BLOCK
    if bits == 8:
        assert s[2] == 1.0 and np.array_equal(
            wire.dequantize_blocks(q, s)[2 * b:3 * b], x[2 * b:3 * b])
    assert s[1] == 1.0 and not q[b:2 * b].any()
    with pytest.raises(ValueError):
        wire.quant_levels(2)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(3, 2, 8, 16), (2, 12, 16, 64),
                                   (5, 3, 7, 10)])
def test_page_codec_bit_identical_to_jax(bits, shape):
    """Pages of one ragged block, twelve whole blocks (the FLAGSHIP page)
    and several ragged ones: the port's tensor codec, the JAX package's
    jnp codec and both numpy wire codecs agree bit for bit."""
    rng = np.random.default_rng(sum(shape) + bits)
    pages = rng.standard_normal(shape).astype(np.float32)
    pages[0] = np.round(pages[0] * 2)        # a small-integer page
    if shape[0] > 2:
        pages[2] = 0.0                       # a zero page
    q, s = quant.quantize_page_blocks(torch.from_numpy(pages), bits)
    jq, js = jquant.quantize_page_blocks(jnp.asarray(pages), bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for i in range(shape[0]):
        nq, ns = pq.quantize_page_np(pages[i], bits)
        jnq, jns = jpq.quantize_page_np(pages[i], bits)
        np.testing.assert_array_equal(nq, q[i].numpy())
        np.testing.assert_array_equal(ns, s[i].numpy())
        np.testing.assert_array_equal(nq, jnq)
        np.testing.assert_array_equal(ns, jns)
        np.testing.assert_array_equal(pq.dequantize_page_np(nq, ns),
                                      jpq.dequantize_page_np(jnq, jns))
    bmap = quant.page_block_map(*shape[1:])
    np.testing.assert_array_equal(
        bmap.numpy(), np.asarray(jquant.page_block_map(*shape[1:])))
    deq = quant.dequantize_page_blocks(q, s, bmap)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(
        jquant.dequantize_page_blocks(jq, js, jquant.page_block_map(
            *shape[1:]))))
    assert pq.num_page_blocks(*shape[1:]) == s.shape[-1] \
        == jpq.num_page_blocks(*shape[1:])
    gq, gs = quant.quantize_grad_blocks(
        torch.from_numpy(pages.reshape(-1, shape[-1])), bits)
    jgq, jgs = jquant.quantize_grad_blocks(
        jnp.asarray(pages.reshape(-1, shape[-1])), bits)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(jgq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(jgs))
    np.testing.assert_array_equal(
        quant.dequantize_grad_blocks(gq, gs).numpy(),
        np.asarray(jquant.dequantize_grad_blocks(jgq, jgs)))


def test_nibble_packing_byte_identical_over_all_values():
    """Every pair of the 15 q4 values (-7..7) in both nibble positions:
    the port's tensor packing equals the JAX package's wire, numpy page
    and jnp page packings byte for byte, and unpacks back."""
    vals = np.arange(-7, 8, dtype=np.int8)
    lo, hi = np.meshgrid(vals, vals, indexing="ij")
    q = np.stack([lo.ravel(), hi.ravel()], -1).reshape(15, 15, 2)
    packed = quant.pack_page_nibbles(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and packed.shape == (15, 15, 1)
    want = jwire.pack_nibbles(q.ravel()).reshape(15, 15, 1)
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(packed.numpy(), wire.pack_nibbles(
        q.ravel()).reshape(15, 15, 1))
    np.testing.assert_array_equal(packed.numpy(), jpq.pack_pages_np(q))
    np.testing.assert_array_equal(packed.numpy(), pq.pack_pages_np(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jquant.pack_page_nibbles(jnp.asarray(q))))
    back = quant.unpack_page_nibbles(packed)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(pq.unpack_pages_np(want), q)
    np.testing.assert_array_equal(
        wire.unpack_nibbles(want.ravel(), q.size), q.ravel())
    np.testing.assert_array_equal(np.asarray(jquant.unpack_page_nibbles(
        jnp.asarray(want))), q)


@pytest.mark.parametrize("bits", BITS)
def test_nibble_round_trip_of_quantized_pages(bits):
    rng = np.random.default_rng(7)
    pages = torch.from_numpy(rng.standard_normal((4, 2, 8, 16))
                             .astype(np.float32))
    q, _ = quant.quantize_page_blocks(pages, 4)
    assert int(q.abs().max()) <= 7
    packed = quant.pack_page_nibbles(q)
    assert packed.shape == (4, 2, 8, 8)
    assert torch.equal(quant.unpack_page_nibbles(packed), q)
    # odd element counts pad a zero high nibble on the wire
    odd = rng.integers(-7, 8, 9).astype(np.int8)
    np.testing.assert_array_equal(
        wire.unpack_nibbles(wire.pack_nibbles(odd), 9), odd)
    np.testing.assert_array_equal(wire.pack_nibbles(odd),
                                  jwire.pack_nibbles(odd))


@pytest.mark.parametrize("bits", BITS)
def test_per_element_error_within_half_scale(bits):
    rng = np.random.default_rng(11)
    pages = torch.from_numpy((rng.standard_normal((6, 4, 16, 32)) * np.exp(
        rng.standard_normal((6, 4, 1, 1)))).astype(np.float32))
    q, s = quant.quantize_page_blocks(pages, bits)
    bmap = quant.page_block_map(4, 16, 32)
    deq = quant.dequantize_page_blocks(q, s, bmap)
    err = (deq - pages).abs()
    bound = s[..., bmap] / 2
    assert (err <= bound * (1 + 1e-6)).all()
    assert (err > 0).any()


def test_resolve_kv_bits_and_odd_head_dim():
    assert [pq.resolve_kv_bits(k) for k in ("f32", "q8", "q4")] == \
        [None, 8, 4] == [jpq.resolve_kv_bits(k) for k in ("f32", "q8", "q4")]
    for bad in ("int8", "q2", "F32"):
        with pytest.raises(ValueError, match="kv_dtype"):
            pq.resolve_kv_bits(bad)
    model = TransformerLM(vocab=61, dim=36, n_layers=1, n_heads=4,
                          max_seq=64, device=CPU,
                          generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="even"):
        PagedSlotPool(model, 2, 32, page_len=8, n_pages=8, kv_dtype="q4")
    PagedSlotPool(model, 2, 32, page_len=8, n_pages=8, kv_dtype="q8")


# ---------------------------------------------------------------------------
# the quantized paged ops against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("block_pages", [1, 2])
def test_quantized_paged_decode_attention_matches_jax(bits, block_pages):
    rng = np.random.default_rng(bits + block_pages)
    b, h, hkv, dh, pl, n_pages, p = 3, 4, 2, 16, 8, 12, 5
    exact = rng.standard_normal((n_pages, hkv, pl, dh)).astype(np.float32)
    vexact = rng.standard_normal((n_pages, hkv, pl, dh)).astype(np.float32)
    kq, ks = quant.quantize_page_blocks(torch.from_numpy(exact), bits)
    vq, vs = quant.quantize_page_blocks(torch.from_numpy(vexact), bits)
    if bits == 4:
        kq, vq = quant.pack_page_nibbles(kq), quant.pack_page_nibbles(vq)
    tables = np.array([[3, 7, 1, 9, 0], [5, 2, 0, 0, 0], [8, 4, 6, 11, 0]],
                      np.int64)
    idx = np.array([13, 5, 30])
    kt = rng.standard_normal((b, hkv, pl, dh)).astype(np.float32)
    vt = rng.standard_normal((b, hkv, pl, dh)).astype(np.float32)
    hq = rng.standard_normal((b, h, 1, dh)).astype(np.float32)
    nk = rng.standard_normal((b, hkv, 1, dh)).astype(np.float32)
    nv = rng.standard_normal((b, hkv, 1, dh)).astype(np.float32)
    t = torch.from_numpy
    got = paged_decode_attention(t(hq), kq, vq, t(tables), t(idx), t(nk),
                                 t(nv), scale=dh ** -0.5, page_len=pl,
                                 block_pages=block_pages, k_scales=ks,
                                 v_scales=vs, k_tail=t(kt), v_tail=t(vt))
    assert got.dtype == torch.float32
    want = jda.paged_decode_attention(
        jnp.asarray(hq), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(tables, jnp.int32), jnp.asarray(idx, jnp.int32),
        jnp.asarray(nk), jnp.asarray(nv), scale=dh ** -0.5, page_len=pl,
        k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy()),
        k_tail=jnp.asarray(kt), v_tail=jnp.asarray(vt))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _quant_pool(n_layers, n_pages, hkv, pl, dh, n_slots, bits):
    """An empty quantized pool as numpy arrays (pages, pages, scales,
    scales, tails, tails)."""
    store = (n_pages, hkv, pl, dh // 2 if bits == 4 else dh)
    sdt = np.uint8 if bits == 4 else np.int8
    nb = pq.num_page_blocks(hkv, pl, dh)
    return ([np.zeros(store, sdt) for _ in range(n_layers)],
            [np.zeros(store, sdt) for _ in range(n_layers)],
            [np.ones((n_pages, nb), np.float32) for _ in range(n_layers)],
            [np.ones((n_pages, nb), np.float32) for _ in range(n_layers)],
            [np.zeros((n_slots, hkv, pl, dh), np.float32)
             for _ in range(n_layers)],
            [np.zeros((n_slots, hkv, pl, dh), np.float32)
             for _ in range(n_layers)])


def _jax_state(state):
    return [[jnp.asarray(np.array(a, copy=True)) for a in part]
            for part in state]


def _np_state(state):
    return [[np.array(np.asarray(a), copy=True) for a in part]
            for part in state]


def _assert_state_equal(port_state, jax_state, what):
    for name, tp, jp in zip(("k_pages", "v_pages", "k_scales", "v_scales",
                             "k_tail", "v_tail"), port_state, jax_state):
        for i, (a, b) in enumerate(zip(tp, jp)):
            a = a.detach().numpy()
            if a.dtype in (np.int8, np.uint8):
                np.testing.assert_array_equal(a, b,
                                              err_msg=f"{what} {name}[{i}]")
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{what} {name}[{i}]")


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("pl,n_kv", [(8, 2), (32, 4)])
def test_quantized_paged_prefill_and_decode_match_jax(bits, pl, n_kv):
    """Cold, partially shared and fully shared admissions into a
    quantized pool, then four decode steps of all three rows (one
    crossing a page boundary and quantizing the page it completes),
    against the JAX functions on the same weights and pool state."""
    jm, params, pm = jax_and_port_lm(seed=2, dim=64, n_heads=4,
                                     n_kv_heads=n_kv)
    dh = pm.dim // pm.n_heads
    n_pages, p = 24, 6
    state = _quant_pool(pm.n_layers, n_pages, n_kv, pl, dh, 3, bits)
    tstate = [[torch.from_numpy(np.array(a, copy=True)) for a in part]
              for part in state]
    rng = np.random.default_rng(5)
    base = rng.integers(0, 61, 2 * pl + 3).astype(np.int32)
    other = np.concatenate([base[:2 * pl], rng.integers(0, 61, pl - 1)]
                           ).astype(np.int32)
    # (prompt, table row, offset): cold (two complete pages + a partial
    # one); two shared pages + an own tail one short of a page; the two
    # shared pages and a one-token tail
    cases = [(base, [0, 1, 2], 0), (other, [0, 1, 3], 2 * pl),
             (base[:2 * pl + 1], [0, 1, 4], 2 * pl)]
    tables = np.zeros((3, p), np.int64)
    lengths = np.zeros(3, np.int64)
    first = []
    for slot, (prompt, row, off) in enumerate(cases):
        tables[slot, :len(row)] = row
        tail = prompt[off:]
        padded = np.zeros((1, 4 * pl), np.int32)
        padded[0, :len(tail)] = tail
        out = jgen.prefill_partial_paged(
            jm, params, *_jax_state(state)[:2],
            jnp.asarray(tables[slot], jnp.int32), jnp.asarray(padded), off,
            len(tail), page_len=pl, kv_bits=bits,
            **dict(zip(("k_scales", "v_scales", "k_tail", "v_tail"),
                       _jax_state(state)[2:])), slot=slot)
        jl, state = out[0], _np_state(out[1:])
        tl = prefill_partial_paged(
            pm, *tstate[:2], tables[slot], torch.from_numpy(padded), off,
            len(tail), page_len=pl, kv_bits=bits,
            **dict(zip(("k_scales", "v_scales", "k_tail", "v_tail"),
                       tstate[2:])), slot=slot)[0]
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        first.append(int(np.argmax(np.asarray(jl))))
        lengths[slot] = len(prompt)
        _assert_state_equal(tstate, state, f"admit {slot}")
    # the cold page completed at admission carries its own scales
    assert not (tstate[2][0][0] == 1).all()
    tables[:, 3] = [5, 6, 7]            # pages for the decode writes
    tokens = np.asarray(first)
    active = np.array([True, True, True])
    for step in range(4):
        out = jgen.decode_step_slots_paged(
            jm, params, *_jax_state(state)[:2],
            jnp.asarray(tables, jnp.int32), jnp.asarray(lengths, jnp.int32),
            jnp.asarray(tokens), jnp.asarray(active), page_len=pl,
            kv_bits=bits, **dict(zip(("k_scales", "v_scales", "k_tail",
                                      "v_tail"), _jax_state(state)[2:])))
        jl, state = out[0], _np_state(out[1:])
        tl = decode_step_slots_paged(
            pm, *tstate[:2], tables, lengths, torch.from_numpy(tokens),
            active, page_len=pl, kv_bits=bits,
            **dict(zip(("k_scales", "v_scales", "k_tail", "v_tail"),
                       tstate[2:])))[0]
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        tokens = np.argmax(np.asarray(jl), axis=-1)
        lengths = lengths + active
        _assert_state_equal(tstate, state, f"decode {step}")
    # row 1 completed page 3 at its first decode step
    assert not (tstate[2][0][3] == 1).all()
    with pytest.raises(ValueError, match="blockwise"):
        decode_step_slots_paged(pm, *tstate[:2], tables, lengths,
                                torch.from_numpy(tokens), active,
                                page_len=pl, kv_bits=bits, blockwise=False)
    with pytest.raises(ValueError, match="k_scales"):
        decode_step_slots_paged(pm, *tstate[:2], tables, lengths,
                                torch.from_numpy(tokens), active,
                                page_len=pl, kv_bits=bits)


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def _lm(**kw):
    kw = {**dict(vocab=61, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 pos="rope", max_seq=128), **kw}
    return TransformerLM(device=CPU, generator=torch.Generator()
                         .manual_seed(0), **kw)


def _greedy(pool, prompt, steps, buckets=(8, 16, 32)):
    """Admit and ``steps`` greedy decodes on slot 0: (tokens, admission
    logits, per-step logits)."""
    first = pool.admit(prompt, 0, buckets)[0][0].clone()
    toks = [int(first.argmax())]
    active = np.zeros(pool.n_slots, bool)
    active[0] = True
    cur = torch.zeros(pool.n_slots, dtype=torch.long)
    steps_out = []
    with torch.inference_mode():
        for _ in range(steps):
            pool.ensure_decode_capacity(0)
            cur[0] = toks[-1]
            lg = pool.decode(cur, active)[0].clone()
            steps_out.append(lg)
            toks.append(int(lg.argmax()))
    return toks, first, steps_out


def test_f32_mode_is_the_exact_pool_bit_for_bit():
    """``kv_dtype="f32"``: model-dtype pages, no scales or tails, and
    every admission and decode step bit-identical to the contiguous
    pool (the exact pool's contract), pages equal to the contiguous
    cache rows."""
    model = _lm(max_seq=512)
    pool = PagedSlotPool(model, 2, 384, page_len=16, n_pages=48,
                         kv_dtype="f32")
    assert pool.k_scales is None and pool.k_tail is None
    assert pool.k_pages[0].dtype == model.dtype
    assert pool.kv_bits() == 32
    contig = SlotPool(model, 2, 384)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 61, n).astype(np.int32) for n in (200, 130)]
    toks = torch.tensor([5, 9])
    with torch.inference_mode():
        for slot, p in enumerate(prompts):
            lp = pool.admit(p, slot, (256,))[0]
            padded = torch.zeros((1, 256), dtype=torch.long)
            padded[0, :len(p)] = torch.from_numpy(p.astype(np.int64))
            assert torch.equal(lp, contig.admit(padded, len(p), slot))
        for _ in range(20):
            for slot in range(2):
                pool.ensure_decode_capacity(slot)
            lp = pool.decode(toks, np.array([True, True]))
            assert torch.equal(lp, contig.decode(toks,
                                                 np.array([True, True])))
            toks = lp.argmax(-1)
    for slot in range(2):
        n = int(pool.lengths[slot])
        for paged, rows in ((pool.k_pages, contig.ks),
                            (pool.v_pages, contig.vs)):
            for pg, row in zip(paged, rows):
                got = pg[torch.as_tensor(pool.owned[slot])].permute(
                    1, 0, 2, 3).reshape(pg.shape[1], -1, pg.shape[-1])
                assert torch.equal(got[:, :n], row[slot, :, :n])


@pytest.mark.parametrize("kv_dtype", ["q8", "q4"])
def test_quantized_pool_cold_logits_exact_and_bounded(kv_dtype):
    model = _lm()
    prompt = np.random.default_rng(0).integers(0, 61, 21).astype(np.int32)
    kw = dict(page_len=8, n_pages=32)
    base = _greedy(PagedSlotPool(model, 2, 64, kv_dtype="f32", **kw),
                   prompt, 12)
    qpool = PagedSlotPool(model, 2, 64, kv_dtype=kv_dtype, **kw)
    toks, first, steps = _greedy(qpool, prompt, 12)
    # a cold admission reads no quantized page: its logits are exact
    assert torch.equal(first, base[1])
    deltas = [float((a - b).abs().max()) for a, b in zip(steps, base[2])]
    assert 0 < max(deltas) < float("inf")
    if kv_dtype == "q8":
        # the JAX package's ceilings on its own smoke model
        assert max(deltas) <= 0.05, deltas
        assert np.mean([a != b for a, b in zip(toks, base[0])]) <= 0.25
    else:
        # the q4 grid (7 levels) is 18x coarser than q8's: its first
        # step off the exact pool is larger than q8's
        q8 = _greedy(PagedSlotPool(model, 2, 64, kv_dtype="q8", **kw),
                     prompt, 1)[2][0]
        assert deltas[0] > float((q8 - base[2][0]).abs().max())


@pytest.mark.parametrize("kv_dtype", ["q8", "q4"])
@pytest.mark.parametrize("s", [13, 16])
def test_cold_prefill_pages_within_half_scale(kv_dtype, s):
    """The pages a cold prefill completes dequantize within scale/2 of
    the exact pool's values, elementwise; the partial page sits exact in
    the slot's tail."""
    model = _lm()
    prompt = np.random.default_rng(3).integers(0, 61, s).astype(np.int32)
    kw = dict(page_len=8, n_pages=16)
    pf = PagedSlotPool(model, 2, 64, kv_dtype="f32", **kw)
    pq_ = PagedSlotPool(model, 2, 64, kv_dtype=kv_dtype, **kw)
    pf.admit(prompt, 1, (16,))
    pq_.admit(prompt, 1, (16,))
    assert pf.owned[1] == pq_.owned[1]
    full = s // 8
    bmap = quant.page_block_map(2, 8, 16)
    for i in range(model.n_layers):
        for ex, qp, sc, tail in (
                (pf.k_pages[i], pq_.k_pages[i], pq_.k_scales[i],
                 pq_.k_tail[i]),
                (pf.v_pages[i], pq_.v_pages[i], pq_.v_scales[i],
                 pq_.v_tail[i])):
            ids = torch.as_tensor(pq_.owned[1][:full])
            q = qp[ids]
            if kv_dtype == "q4":
                q = quant.unpack_page_nibbles(q)
            deq = quant.dequantize_page_blocks(q, sc[ids], bmap)
            err = (deq - ex[ids]).abs()
            assert (err <= sc[ids][..., bmap] / 2 * (1 + 1e-6)).all()
            assert (err > 0).any()
            part = s - full * 8
            last = pf.owned[1][full] if part else None
            if part:
                assert torch.equal(tail[1, :, :part], ex[last][:, :part])
            assert not tail[1, :, part:].any()
            assert not tail[0].any()


def test_capacity_arithmetic():
    """Bytes per resident token: pages (+ scales) over n_pages x
    page_len; the pool bytes add the per-slot f32 tails."""
    model = _lm(n_kv_heads=4)           # a page of 4 x 16 x 16 = 1024
    n_pages, slots = 32, 3
    got = {}
    for kv in ("f32", "q8", "q4"):
        pool = PagedSlotPool(model, slots, 64, page_len=16,
                             n_pages=n_pages, kv_dtype=kv)
        got[kv] = pool
    layers, elems = model.n_layers, 4 * 16 * 16
    assert got["f32"].bytes_per_resident_token() == layers * 2 * 64 * 4
    assert got["q8"].bytes_per_resident_token() == \
        layers * 2 * (elems + 4) / 16
    assert got["q4"].bytes_per_resident_token() == \
        layers * 2 * (elems // 2 + 4) / 16
    tails = layers * 2 * slots * elems * 4
    for kv, bits in (("q8", 8), ("q4", 4)):
        ps = got[kv].page_stats()
        assert ps["kv_bits"] == bits and ps["kv_dtype"] == kv
        assert ps["kv_pool_bytes"] == \
            got[kv].bytes_per_resident_token() * n_pages * 16 + tails
    assert got["f32"].kv_pool_bytes() == \
        got["f32"].bytes_per_resident_token() * n_pages * 16


def test_engine_kv_dtype_config_errors_and_env(monkeypatch):
    model = _lm(n_layers=1)
    with pytest.raises(ValueError, match="kv_dtype"):
        InferenceEngine(model, EngineConfig(paged=True, page_len=8,
                                            kv_dtype="int4"))
    with pytest.raises(ValueError, match="paged=True"):
        InferenceEngine(model, EngineConfig(kv_dtype="q8"))
    InferenceEngine(model, EngineConfig(kv_dtype="f32"))
    monkeypatch.setenv("DPX_SERVE_KV_DTYPE", "q4")
    # the env drives a paged pool and is ignored by a contiguous one
    eng = InferenceEngine(model, EngineConfig(paged=True, page_len=8))
    assert eng.stats()["pages"]["kv_dtype"] == "q4"
    assert not InferenceEngine(model, EngineConfig()).stats()["paged"]


@pytest.mark.parametrize("kv_dtype", ["q8", "q4"])
def test_engine_serves_quantized_shared_prefix(kv_dtype):
    """Through ``submit``: a shared-prefix mix on a quantized pool, the
    cold request's first token equal to the exact pool's, prefix hits
    over quantized pages, every page back after draining the index."""
    model = _lm()
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 61, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 61, 5 + i)])
               for i in range(3)] + [rng.integers(0, 61, 11)]
    sp = SamplingParams(max_new_tokens=8)

    def run(kv):
        eng = InferenceEngine(model, EngineConfig(
            paged=True, n_slots=3, max_len=64, page_len=8, kv_dtype=kv))
        with eng:
            outs = [h.result(timeout=60) for h in
                    [eng.submit(p, sp) for p in prompts]]
        return eng, outs

    ef, of = run("f32")
    eq, oq = run(kv_dtype)
    assert oq[0][0] == of[0][0] and oq[3][0] == of[3][0]
    ps = eq.stats()["pages"]
    assert ps["prefix_hit_pages"] == 4 and ps["kv_dtype"] == kv_dtype
    assert eq.pool.pool.live_pages() == 0
    pool = eq.pool.pool
    while (pid := eq.pool.index.evict_lru(pool)) is not None:
        pool.reclaim(pid)
        pool.release_to_free(pid)
    assert pool.free_pages == ps["n_pages"]
    ratio = (ef.stats()["pages"]["bytes_per_resident_token"]
             / ps["bytes_per_resident_token"])
    assert ratio > (3.5 if kv_dtype == "q8" else 7.0)
