"""Flash attention forward of the PyTorch port against the JAX package.

The port's plain blockwise version (what a CPU tensor runs) is held to
the JAX Pallas kernel run in interpret mode over every masking case of
the forward kernel: causal / full, ragged lengths, GQA, s_q != s_k, rows
with no visible key (NaN), sliding window, causal_offset and
diag_offset. f32, |diff| <= 2e-5 on O and lse: both sides accumulate
in float32 and differ only in summation order. The CUDA kernel itself
is compared with the plain version by ``test_torch_cuda_kernels.py`` and
by ``chip_smoke.py`` on the card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu_torch.nn.attention import dense_attention
from distributed_pytorch_tpu_torch.ops import flash_attention as tflash

# the JAX package's ops/__init__ re-exports a function under the module's
# name, so the module is looked up explicitly
jflash = importlib.import_module("distributed_pytorch_tpu.ops.flash_attention")

TOL = 2e-5

# (name, b, h, h_kv, s_q, s_k, d, kwargs)
CASES = [
    ("full", 2, 4, 4, 48, 48, 16, dict(causal=False)),
    ("causal", 2, 4, 4, 64, 64, 16, dict(causal=True)),
    ("ragged", 1, 4, 4, 50, 50, 16, dict(causal=True)),
    ("gqa", 1, 4, 2, 40, 40, 16, dict(causal=True)),
    ("sq_lt_sk", 1, 2, 2, 24, 72, 16, dict(causal=True)),
    ("sq_gt_sk_nan_rows", 1, 2, 2, 56, 24, 16, dict(causal=True)),
    ("window", 1, 4, 2, 64, 64, 16, dict(causal=True, window=12)),
    ("causal_offset", 1, 2, 2, 40, 40, 16, dict(causal=True,
                                                 causal_offset=1)),
    ("diag_offset", 1, 2, 2, 32, 32, 16, dict(causal=True, diag_offset=20,
                                               window=24)),
]


def _inputs(seed, b, h, h_kv, s_q, s_k, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s_q, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, s_k, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, s_k, d)).astype(np.float32)
    return q, k, v


def _assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_flash_matches_jax_kernel(case):
    _, b, h, h_kv, s_q, s_k, d, kw = case
    q, k, v = _inputs(len(case[0]), b, h, h_kv, s_q, s_k, d)
    o_j, lse_j = jflash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=16,
        block_k=16, interpret=True, **kw)
    o_t, lse_t = tflash.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    _assert_same(o_t.numpy(), o_j)
    _assert_same(lse_t.numpy(), lse_j)
    if case[0] == "sq_gt_sk_nan_rows":
        assert np.isnan(o_t.numpy()).any()


#: the tests' small tiles, the kernels' 64 x 64 and larger Hopper tiles
TILINGS = [(16, 16), (32, 8), (64, 64), (128, 64), (128, 128)]

# (name, b, h, h_kv, s, kwargs): sequences longer than the kernels' tiles,
# ragged against 64 and 128, for the plain version at those tilings
LONG_CASES = [
    ("ragged_causal", 1, 2, 2, 200, dict(causal=True)),
    ("gqa_window", 1, 4, 2, 300, dict(causal=True, window=70)),
]


@pytest.mark.parametrize("blocks", TILINGS)
def test_plain_flash_is_tiling_invariant(blocks):
    """The plain version's tile sizes change only the summation order:
    the kernel's 64 x 64 tiling and the tests' small tiles agree."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 1, 4, 2, 70, 70, 16))
    ref, ref_lse = tflash.flash_attention_fwd_reference(
        q, k, v, causal=True, window=20)
    o, lse = tflash.flash_attention_fwd_reference(
        q, k, v, causal=True, window=20, block_q=blocks[0],
        block_k=blocks[1])
    _assert_same(o.numpy(), ref.numpy())
    _assert_same(lse.numpy(), ref_lse.numpy())


@pytest.mark.parametrize("blocks", TILINGS[2:])
@pytest.mark.parametrize("case", LONG_CASES, ids=[c[0] for c in LONG_CASES])
def test_plain_flash_at_kernel_tiles_matches_jax_and_dense(case, blocks):
    """At the Hopper kernels' tile shapes, over ragged and windowed
    sequences longer than one tile, the plain version equals the JAX
    kernel (interpret mode, its own 64 x 64 tiles) and dense attention."""
    _, b, h, h_kv, s, kw = case
    q, k, v = _inputs(11, b, h, h_kv, s, s, 16)
    o_j, lse_j = jflash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64,
        block_k=64, interpret=True, **kw)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o_t, lse_t = tflash.flash_attention_fwd_reference(
        qt, kt, vt, block_q=blocks[0], block_k=blocks[1], **kw)
    _assert_same(o_t.numpy(), o_j)
    _assert_same(lse_t.numpy(), lse_j)
    _assert_same(o_t.numpy(), dense_attention(qt, kt, vt, **kw).numpy())


def test_plain_flash_matches_dense_attention():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 2, 4, 2, 33, 33, 16))
    got = tflash.flash_attention(q, k, v, causal=True, window=9)
    want = dense_attention(q, k, v, causal=True, window=9)
    _assert_same(got.numpy(), want.numpy())


BAD_ARGS = [
    dict(causal=False, window=4),
    dict(causal=True, window=0),
    dict(causal=False, causal_offset=1),
    dict(causal=True, causal_offset=1, window=4),
    dict(causal=True, causal_offset=2),
    dict(causal=False, diag_offset=3),
]


@pytest.mark.parametrize("kw", BAD_ARGS)
def test_invalid_arguments_raise_like_jax(kw):
    q, k, v = _inputs(5, 1, 2, 2, 8, 8, 16)
    with pytest.raises(ValueError):
        jflash.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), interpret=True, **kw)
    with pytest.raises(ValueError):
        tflash.flash_attention_with_lse(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), **kw)


def test_cpu_tensors_never_reach_the_kernel_wrapper():
    q, k, v = (torch.from_numpy(x) for x in _inputs(6, 1, 2, 2, 8, 8, 64))
    before = tflash.LAUNCHES["flash_attention_fwd"]
    tflash.flash_attention(q, k, v, causal=True)
    assert tflash.LAUNCHES["flash_attention_fwd"] == before
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_fwd_cuda(q, k, v, causal=True)


def test_make_flash_attn_fn_dispatch_and_attributes():
    fn = tflash.make_flash_attn_fn(min_seq_flash=32)
    assert fn.dense_equivalent and fn.window is None
    wfn = tflash.make_flash_attn_fn(window=8, min_seq_flash=None)
    assert not wfn.dense_equivalent and wfn.window == 8
    q, k, v = (torch.from_numpy(x) for x in _inputs(7, 1, 4, 2, 20, 20, 16))
    # below the threshold: dense attention, same function
    _assert_same(fn(q, k, v, causal=True).numpy(),
                 dense_attention(q, k, v, causal=True).numpy())
    _assert_same(wfn(q, k, v, causal=True).numpy(),
                 dense_attention(q, k, v, causal=True, window=8).numpy())
