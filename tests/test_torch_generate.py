"""Cached generation of the PyTorch port against the JAX package.

Prefill, right-padded prefill, decode steps (single cache and slot
pool), blockwise vs dense decode attention, the sampling filters and
whole greedy token streams, all at float32 with |diff| <= 1e-4 on
logits (summation order only) and exact equality on greedy tokens.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_and_port_lm, to_np
from distributed_pytorch_tpu.nn.attention import \
    dense_attention as jax_dense
from distributed_pytorch_tpu.ops.flash_attention import \
    make_flash_attn_fn as jax_flash_fn
from distributed_pytorch_tpu_torch.models import generate as tgen
from distributed_pytorch_tpu_torch.ops import decode_attention as tdec
from distributed_pytorch_tpu_torch.ops.flash_attention import \
    make_flash_attn_fn

# the JAX package's __init__ files re-export functions under their
# modules' names, so the modules are looked up explicitly
jgen = importlib.import_module("distributed_pytorch_tpu.models.generate")
jdec = importlib.import_module("distributed_pytorch_tpu.ops.decode_attention")

TOL = 1e-4
MAX_LEN = 48


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(to_np(got) if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), atol=tol, rtol=0)


def _jax_window_fn(w):
    def fn(q, k, v, *, causal=False, scale=None):
        return jax_dense(q, k, v, causal=causal, scale=scale, window=w)
    fn.window = w
    return fn


def _prompt(seed, b, s):
    return np.random.default_rng(seed).integers(0, 61, (b, s))


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_prefill_and_decode_step_match_jax(pos):
    jm, params, pm = jax_and_port_lm(seed=0, pos=pos)
    prompt = _prompt(0, 2, 9)
    j_logits, j_cache = jgen.prefill(jm, params, jnp.asarray(prompt), MAX_LEN)
    with torch.inference_mode():
        t_logits, t_cache = tgen.prefill(pm, prompt, MAX_LEN)
        _close(t_logits, j_logits)
        assert t_cache.length == 9
        for i in range(pm.n_layers):
            _close(t_cache.k[i][:, :, :9], np.asarray(j_cache.k[i])[:, :, :9])
            _close(t_cache.v[i][:, :, :9], np.asarray(j_cache.v[i])[:, :, :9])
        tok = np.asarray([3, 17])
        j_l, j_cache = jgen.decode_step(jm, params, j_cache,
                                        jnp.asarray(tok, jnp.int32))
        t_l, t_cache = tgen.decode_step(pm, t_cache, tok)
        _close(t_l, j_l)
        assert t_cache.length == 10
        # dense decode is the reference of the blockwise one
        _, cache2 = tgen.prefill(pm, prompt, MAX_LEN)
        d_l, _ = tgen.decode_step(pm, cache2, tok, blockwise=False)
        _close(t_l, to_np(d_l))


def test_prefill_partial_matches_jax():
    jm, params, pm = jax_and_port_lm(seed=1)
    prompt = _prompt(1, 1, 7)
    padded = np.zeros((1, 16), np.int64)
    padded[:, :7] = prompt
    j_l, j_ks, j_vs = jgen.prefill_partial(jm, params,
                                           jnp.asarray(padded, jnp.int32), 7)
    with torch.inference_mode():
        t_l, t_ks, t_vs = tgen.prefill_partial(pm, padded, 7)
        exact, _ = tgen.prefill(pm, prompt, MAX_LEN)
    _close(t_l, j_l)
    # right padding is inert under causality (to a tolerance: the
    # padded and exact shapes sum in different orders)
    _close(t_l, to_np(exact))
    for i in range(pm.n_layers):
        _close(t_ks[i][:, :, :7], np.asarray(j_ks[i])[:, :, :7])
        _close(t_vs[i][:, :, :7], np.asarray(j_vs[i])[:, :, :7])


def test_decode_step_slots_matches_jax():
    jm, params, pm = jax_and_port_lm(seed=2)
    rng = np.random.default_rng(2)
    shape = (3, pm.n_kv_heads, MAX_LEN, pm.dim // pm.n_heads)
    ks = [rng.standard_normal(shape).astype(np.float32)
          for _ in range(pm.n_layers)]
    vs = [rng.standard_normal(shape).astype(np.float32)
          for _ in range(pm.n_layers)]
    lengths = np.asarray([6, 0, 31])
    tokens = np.asarray([7, 1, 60])
    j_l, j_ks, _ = jgen.decode_step_slots(
        jm, params, [jnp.asarray(k) for k in ks], [jnp.asarray(v) for v in vs],
        jnp.asarray(lengths, jnp.int32), jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        t_ks = [torch.from_numpy(k.copy()) for k in ks]
        t_vs = [torch.from_numpy(v.copy()) for v in vs]
        t_l, t_ks, t_vs = tgen.decode_step_slots(pm, t_ks, t_vs, lengths,
                                                 tokens)
        d_l, _, _ = tgen.decode_step_slots(
            pm, [torch.from_numpy(k.copy()) for k in ks],
            [torch.from_numpy(v.copy()) for v in vs], lengths, tokens,
            blockwise=False)
    _close(t_l, j_l)
    _close(t_l, to_np(d_l))
    for i in range(pm.n_layers):
        _close(t_ks[i], j_ks[i])


@pytest.mark.parametrize("block_len", [16, 128])
def test_blockwise_decode_matches_dense_and_jax(block_len):
    rng = np.random.default_rng(3)
    b, h, hkv, w, d = 3, 4, 2, 70, 16
    hq = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, w, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, w, d)).astype(np.float32)
    idx = np.asarray([5, 40, 17])
    scale = d ** -0.5
    t_idx = torch.from_numpy(idx)
    got = tdec.blockwise_decode_attention(
        torch.from_numpy(hq), torch.from_numpy(k), torch.from_numpy(v),
        t_idx, scale=scale, block_len=block_len)
    mask = torch.arange(w)[None, :] <= t_idx[:, None]
    dense = tdec.dense_decode_attention(
        torch.from_numpy(hq), torch.from_numpy(k), torch.from_numpy(v), mask,
        scale=scale)
    want = jdec.blockwise_decode_attention(
        jnp.asarray(hq), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(idx, jnp.int32), scale=scale, block_len=block_len)
    _close(got, want)
    _close(got, to_np(dense))
    assert tdec.resident_blocks(idx, block_len, -(-w // block_len)) == \
        int(jdec.resident_blocks(jnp.asarray(idx), block_len,
                                 -(-w // block_len)))


def test_windowed_prefill_layouts_match_jax():
    W = 8
    jm, params, pm = jax_and_port_lm(
        seed=4, jax_attn_fn=_jax_window_fn(W),
        port_attn_fn=make_flash_attn_fn(window=W, min_seq_flash=None))
    for s in (5, 20):
        prompt = _prompt(s, 1, s)
        padded = np.zeros((1, 32), np.int64)
        padded[:, :s] = prompt
        _, j_cache = jgen.prefill(jm, params, jnp.asarray(prompt), MAX_LEN,
                                  window=W)
        _, j_ks, _ = jgen.prefill_partial(jm, params,
                                          jnp.asarray(padded, jnp.int32), s,
                                          window=W)
        with torch.inference_mode():
            _, t_cache = tgen.prefill(pm, prompt, MAX_LEN, window=W)
            _, t_ks, _ = tgen.prefill_partial(pm, padded, s, window=W)
        for i in range(pm.n_layers):
            _close(t_cache.k[i], j_cache.k[i])
            _close(t_ks[i], j_ks[i])


SAMPLERS = [(1.0, 5, None), (0.7, None, 0.8), (1.3, 12, 0.5),
            (0.9, None, 0.0)]


@pytest.mark.parametrize("t,top_k,top_p", SAMPLERS)
def test_sampling_filters_match_jax(t, top_k, top_p):
    """jax.random.categorical is argmax(logits + gumbel(key)): adding the
    same Gumbel noise to the port's filtered logits must reproduce every
    JAX sample, which pins the kept set (and the temperature scaling)."""
    logits = np.random.default_rng(5).standard_normal((2, 61)) \
        .astype(np.float32) * 3
    filt = to_np(tgen._filter_logits(torch.from_numpy(logits), t, top_k,
                                     top_p))
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jgen._sample(jnp.asarray(logits), key, t, top_k,
                                       top_p))
        g = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
        np.testing.assert_array_equal(np.argmax(filt + g, axis=-1), want)
    kept = np.isfinite(filt).sum(axis=-1)
    assert (kept >= 1).all()
    if top_k is not None:
        assert (kept <= top_k).all()


def test_greedy_stream_matches_jax_with_flash():
    jm, params, pm = jax_and_port_lm(
        seed=6, jax_attn_fn=jax_flash_fn(block_q=16, block_k=16,
                                         min_seq_flash=None),
        port_attn_fn=make_flash_attn_fn(min_seq_flash=None))
    prompt = _prompt(6, 2, 12)
    want = np.asarray(jax.jit(jgen.make_generate_fn(jm, 10))(
        params, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(0)))
    got = tgen.generate(pm, prompt, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_windowed_greedy_stream_matches_jax():
    W = 8
    jm, params, pm = jax_and_port_lm(
        seed=7, jax_attn_fn=_jax_window_fn(W),
        port_attn_fn=make_flash_attn_fn(window=W, min_seq_flash=None))
    prompt = _prompt(7, 1, 6)
    want = np.asarray(jax.jit(jgen.make_generate_fn(jm, 20))(
        params, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(tgen.generate(pm, prompt, 20).numpy(),
                                  want)


def test_sampled_generate_is_reproducible_per_generator():
    _, _, pm = jax_and_port_lm(seed=8)
    prompt = _prompt(8, 1, 5)
    kw = dict(temperature=0.8, top_k=20)
    a = tgen.generate(pm, prompt, 12, generator=torch.Generator()
                      .manual_seed(3), **kw)
    b = tgen.generate(pm, prompt, 12, generator=torch.Generator()
                      .manual_seed(3), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_generate_validates_lengths():
    _, _, pm = jax_and_port_lm(seed=9, max_seq=32)
    with pytest.raises(ValueError, match="max_seq"):
        tgen.generate(pm, _prompt(9, 1, 30), 5)
    with pytest.raises(ValueError, match="cannot hold"):
        tgen.generate(pm, _prompt(9, 1, 10), 5, max_len=12)


def test_custom_attn_fn_refused_and_windows_must_agree():
    _, _, pm = jax_and_port_lm(seed=10, port_attn_fn=lambda q, k, v, **_: q)
    with pytest.raises(ValueError, match="custom attn_fn"):
        tgen.make_generate_fn(pm, 4)
    tgen.make_generate_fn(pm, 4, allow_custom_attn=True)   # opted in
    _, _, pm = jax_and_port_lm(seed=10)
    pm.blocks[0].attn.attn_fn = make_flash_attn_fn(window=4)
    pm.blocks[1].attn.attn_fn = make_flash_attn_fn(window=8)
    with pytest.raises(ValueError, match="uniform"):
        tgen._model_window(pm)
