"""Flash attention backward of the PyTorch port against the JAX package.

The port's plain blockwise backward (what a CPU tensor runs, and what
``chip_smoke.py`` holds the dK/dV and dQ kernels to on the card) is held
to ``jax.vjp`` of the JAX package's ``flash_attention_with_lse`` run in
interpret mode, over every masking case of the forward tests, with
seeded cotangents of both outputs (O and lse). Rows with no visible key
(NaN O) take zero cotangents, as a caller weighting them to zero gives
them, and their gradients must come out finite. float32, |diff| <= 1e-4:
both sides accumulate in float32 and differ only in summation order.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu_torch.nn.attention import dense_attention
from distributed_pytorch_tpu_torch.ops import flash_attention as tflash
from test_torch_flash_attention import CASES, LONG_CASES, TILINGS, _inputs

jflash = importlib.import_module("distributed_pytorch_tpu.ops.flash_attention")

TOL = 1e-4


def _cotangents(seed, o, lse):
    """Seeded (dO, g_lse) as numpy, zero on the NaN rows of ``o``."""
    rng = np.random.default_rng(seed)
    nan_rows = np.isnan(np.asarray(o)).any(axis=-1)
    g_o = rng.standard_normal(np.shape(o)).astype(np.float32)
    g_lse = rng.standard_normal(np.shape(lse)).astype(np.float32)
    g_o[nan_rows] = 0.0
    g_lse[nan_rows] = 0.0
    return g_o, g_lse


def _port_grads(q, k, v, g_o, g_lse, kw, **blocks):
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = tflash.flash_attention_fwd_reference(qt, kt, vt, **kw)
    return tflash.flash_attention_bwd_reference(
        qt, kt, vt, o, lse, torch.from_numpy(g_o),
        None if g_lse is None else torch.from_numpy(g_lse), **kw, **blocks)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax_vjp(case):
    name, b, h, h_kv, s_q, s_k, d, kw = case
    q, k, v = _inputs(len(name), b, h, h_kv, s_q, s_k, d)

    def f(q, k, v):
        return jflash.flash_attention_with_lse(
            q, k, v, block_q=16, block_k=16, interpret=True, **kw)

    (o, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    g_o, g_lse = _cotangents(7 + len(name), o, lse)
    want = vjp((jnp.asarray(g_o), jnp.asarray(g_lse)))
    got = _port_grads(q, k, v, g_o, g_lse, kw)
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.numpy()
        assert np.isfinite(g).all(), label
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0,
                                   err_msg=label)
    if name == "sq_gt_sk_nan_rows":
        assert np.isnan(np.asarray(o)).any()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_autograd_runs_the_plain_backward(case):
    """autograd through the port's flash_attention_with_lse (the
    autograd.Function) gives exactly the plain backward's gradients."""
    name, b, h, h_kv, s_q, s_k, d, kw = case
    q, k, v = _inputs(len(name), b, h, h_kv, s_q, s_k, d)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o, lse = tflash.flash_attention_with_lse(qt, kt, vt, **kw)
    g_o, g_lse = _cotangents(3, o.detach(), lse.detach())
    torch.autograd.backward((o, lse), (torch.from_numpy(g_o),
                                       torch.from_numpy(g_lse)))
    want = _port_grads(q, k, v, g_o, g_lse, kw)
    for t, w in zip((qt, kt, vt), want):
        torch.testing.assert_close(t.grad, w, atol=0, rtol=0)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=9)],
                         ids=["causal", "full", "window"])
def test_autograd_matches_dense_attention(kw):
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(4, 2, 4, 2, 33, 33, 16))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 4, 33, 16)).astype(np.float32))
    got = torch.autograd.grad((tflash.flash_attention(q, k, v, **kw) * g)
                              .sum(), (q, k, v))
    want = torch.autograd.grad((dense_attention(q, k, v, **kw) * g).sum(),
                               (q, k, v))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=TOL, rtol=0)


def test_lse_only_cotangent():
    """Only lse used: O's cotangent is None inside the Function and
    counts as zeros; the gradient is that of logsumexp(q k^T scale)."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(6, 1, 2, 2, 20, 20, 16))
    _, lse = tflash.flash_attention_with_lse(q, k, v, causal=True)
    dq, dk = torch.autograd.grad(lse.sum(), (q, k))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / 4.0
    s = s.masked_fill(~torch.tril(torch.ones(20, 20, dtype=torch.bool)),
                      float("-inf"))
    want = torch.autograd.grad(torch.logsumexp(s, -1).sum(), (q, k))
    torch.testing.assert_close(dq, want[0], atol=TOL, rtol=0)
    torch.testing.assert_close(dk, want[1], atol=TOL, rtol=0)


@pytest.mark.parametrize("blocks", TILINGS)
def test_plain_backward_is_tiling_invariant(blocks):
    """Tile sizes change only the summation order: the kernels' 64 x 64
    tiling and the tests' small tiles give the same gradients."""
    kw = dict(causal=True, window=20)
    q, k, v = _inputs(3, 1, 4, 2, 70, 70, 16)
    g_o = np.random.default_rng(8).standard_normal((1, 4, 70, 16)).astype(
        np.float32)
    ref = _port_grads(q, k, v, g_o, None, kw)
    got = _port_grads(q, k, v, g_o, None, kw, block_q=blocks[0],
                      block_k=blocks[1])
    for a, w in zip(got, ref):
        torch.testing.assert_close(a, w, atol=TOL, rtol=0)


@pytest.mark.parametrize("blocks", TILINGS[2:])
@pytest.mark.parametrize("case", LONG_CASES, ids=[c[0] for c in LONG_CASES])
def test_plain_backward_at_kernel_tiles_matches_jax_and_dense(case, blocks):
    """At the Hopper kernels' tile shapes, over ragged and windowed
    sequences longer than one tile, the plain backward equals ``jax.vjp``
    of the JAX kernels (interpret mode, 64 x 64 tiles) and autograd
    through dense attention."""
    name, b, h, h_kv, s, kw = case
    q, k, v = _inputs(12, b, h, h_kv, s, s, 16)

    def f(q, k, v):
        return jflash.flash_attention_with_lse(
            q, k, v, block_q=64, block_k=64, interpret=True, **kw)

    (o, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    g_o, g_lse = _cotangents(13, o, lse)
    want = vjp((jnp.asarray(g_o), jnp.asarray(g_lse)))
    got = _port_grads(q, k, v, g_o, g_lse, kw, block_q=blocks[0],
                      block_k=blocks[1])
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=label)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    dense = torch.autograd.grad(
        (dense_attention(qt, kt, vt, **kw) * torch.from_numpy(g_o)).sum(),
        (qt, kt, vt))
    plain = _port_grads(q, k, v, g_o, None, kw, block_q=blocks[0],
                        block_k=blocks[1])
    for label, g, w in zip(("dq", "dk", "dv"), plain, dense):
        torch.testing.assert_close(g, w, atol=TOL, rtol=0, msg=label)


def test_cpu_tensors_never_reach_the_backward_kernels():
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(9, 1, 2, 2, 8, 8, 64))
    before = dict(tflash.LAUNCHES)
    tflash.flash_attention(q, k, v, causal=True).sum().backward()
    assert tflash.LAUNCHES == before
    o, lse = tflash.flash_attention_fwd_reference(q.detach(), k.detach(),
                                                  v.detach())
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_bwd_cuda(q.detach(), k.detach(), v.detach(),
                                        o, lse, o)
