"""TransformerLM of the PyTorch port against the JAX package.

The JAX model initializes the weights; ``convert.from_jax_params`` loads
them into the port. Logits agree to |diff| <= 1e-4 at float32 (summation
order only) for learned / rope / no positions, grouped-query attention
and tied embeddings, with dense attention and with the flash attn_fn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, jax_and_port_lm, small_lm_kwargs, to_np
from distributed_pytorch_tpu.ops.flash_attention import \
    make_flash_attn_fn as jax_flash_fn
from distributed_pytorch_tpu_torch import TransformerLM, from_jax_params
from distributed_pytorch_tpu_torch.ops.flash_attention import \
    make_flash_attn_fn

TOL = 1e-4

CONFIGS = {
    "learned_mha": dict(pos="learned", n_kv_heads=None),
    "rope_gqa": dict(pos="rope", n_kv_heads=2),
    "learned_tied": dict(pos="learned", tie_embeddings=True),
    "none_gqa_tied": dict(pos="none", n_kv_heads=1, tie_embeddings=True),
    "rope_dim64": dict(pos="rope", dim=64, n_heads=4, n_kv_heads=2),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_jax(name):
    jm, params, pm = jax_and_port_lm(seed=1, **CONFIGS[name])
    tokens = np.random.default_rng(0).integers(0, 61, (2, 19))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(tokens,
                                                             jnp.int32)))
    with torch.inference_mode():
        got = to_np(pm(torch.from_numpy(tokens)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_logits_match_jax_through_flash_attn_fn():
    jm, params, pm = jax_and_port_lm(
        seed=2, jax_attn_fn=jax_flash_fn(block_q=16, block_k=16,
                                         min_seq_flash=None),
        port_attn_fn=make_flash_attn_fn(min_seq_flash=None))
    tokens = np.random.default_rng(1).integers(0, 61, (1, 37))
    want = np.asarray(jm.apply(params, jnp.asarray(tokens, jnp.int32)))
    with torch.inference_mode():
        got = to_np(pm(torch.from_numpy(tokens)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_param_layout_after_conversion():
    jm, params, pm = jax_and_port_lm(seed=3, pos="learned")
    w = np.asarray(params["blocks"][0]["attn"]["qkv"]["w"])   # (in, out)
    np.testing.assert_array_equal(to_np(pm.blocks[0].attn.qkv.weight), w.T)
    np.testing.assert_array_equal(to_np(pm.pos.weight),
                                  np.asarray(params["pos"]["emb"]))
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in pm.parameters())


def test_conversion_rejects_shape_mismatch():
    jm, params, _ = jax_and_port_lm(seed=4)
    other = TransformerLM(device=CPU, **small_lm_kwargs(dim=64))
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(jax.tree_util.tree_map(np.asarray, params), other)


def test_seeded_init_is_reproducible():
    kw = small_lm_kwargs()
    a = TransformerLM(device=CPU, generator=torch.Generator().manual_seed(5),
                      **kw)
    b = TransformerLM(device=CPU, generator=torch.Generator().manual_seed(5),
                      **kw)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
