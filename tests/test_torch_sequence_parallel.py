"""Sequence parallelism of the port (``parallel/sequence.py``,
``parallel/spmd.py``) against the JAX package, in one process.

- ``stripe_tokens`` / ``unstripe_tokens`` equal JAX's and invert each
  other; ``_merge_lse`` equals JAX's, floor partials included.
- The flash ring of 4 ranks replayed in this process through the
  module's own hop loop (``_ring_flash`` with a shift that hands rank
  ``my`` the block of rank ``(my - t - 1) % n``, as ``chip_smoke.py``
  replays it on the card): causal, non-causal, sliding-window (windows
  inside a shard, across shards and wider than the sequence) and the
  striped ring, output and q/k/v gradients against JAX's
  ``shard_map`` of the same function on a 4-shard ``sp`` axis (values
  ``atol 2e-5``, gradients ``5e-4``, as ``tests/test_sequence_parallel
  .py``), with an lse cotangent through the merge.
- The windowed ring runs as many hops as JAX's static ``t_hi``.
- The refusals are JAX's ``ValueError``s.

Serial run time ~46 s.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import distributed_pytorch_tpu as jdist
from distributed_pytorch_tpu.parallel import sequence as jseq
from distributed_pytorch_tpu.parallel import spmd as jspmd
from distributed_pytorch_tpu.runtime import context as jcontext
from distributed_pytorch_tpu.runtime.jax_compat import shard_map
from distributed_pytorch_tpu_torch.ops import flash_attention as tflash
from distributed_pytorch_tpu_torch.parallel import sequence as seq
from distributed_pytorch_tpu_torch.parallel import spmd

# the module (``distributed_pytorch_tpu.ops`` exports a function of
# the same name)
jflash_mod = importlib.import_module(
    "distributed_pytorch_tpu.ops.flash_attention")
N = 4
SHAPE = (2, 2, 64, 8)          # 16 tokens per shard
VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def sp_mesh():
    mesh = jcontext.init_mesh(dp=2, sp=N)
    yield mesh
    jdist.cleanup()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(SHAPE).astype(np.float32)
                   for _ in range(4))
    return q, k, v, do


def _jax_ring(mesh, q, k, v, do, *, causal, window=None, striped=False):
    """JAX's ring over sp (the striped one on striped inputs): output and
    the gradients of sum(o * do)."""
    spec = JP(None, None, "sp", None)
    if striped:
        q, k, v, do = (jseq.stripe_tokens(jnp.asarray(t), N, axis=2)
                       for t in (q, k, v, do))

        def core(a, b_, c):
            return jseq.striped_ring_flash_attention(
                a, b_, c, axis_name="sp", block_q=8, block_k=8)
    else:
        def core(a, b_, c):
            return jseq.ring_flash_attention(
                a, b_, c, axis_name="sp", causal=causal, window=window,
                block_q=8, block_k=8)
    f = shard_map(core, mesh=mesh, in_specs=(spec, spec, spec),
                  out_specs=spec, check_vma=False)

    def loss(a, b_, c):
        return jnp.sum(f(a, b_, c) * do)
    o = jax.jit(f)(q, k, v)
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    if striped:
        o = jseq.unstripe_tokens(o, N, axis=2)
        g = tuple(jseq.unstripe_tokens(t, N, axis=2) for t in g)
    return [np.asarray(o)] + [np.asarray(t) for t in g]


def _replay(q, k, v, n, **kw):
    """The port's ring of n ranks in this process (``chip_smoke``'s
    replay): each rank's hops through ``_ring_flash``."""
    s_loc = q.shape[2] // n

    def blocks(t):
        return [t[:, :, r * s_loc:(r + 1) * s_loc] for r in range(n)]
    qs, ks, vs = blocks(q), blocks(k), blocks(v)
    outs, lses = [], []
    for my in range(n):
        def shift(t, kt, vt, my=my):
            src = (my - t - 1) % n
            return ks[src], vs[src]
        o, lse = seq._ring_flash(qs[my], ks[my], vs[my], my, n, shift,
                                 scale=None, **kw)
        outs.append(o.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _port_ring(q, k, v, do, *, causal, window=None, striped=False):
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    if striped:
        qs, ks, vs = (seq.stripe_tokens(t, N, axis=2) for t in leaves)
        o, lse = _replay(qs, ks, vs, N, causal=True, striped=True)
        o = seq.unstripe_tokens(o, N, axis=2)
        lse = seq.unstripe_tokens(lse, N, axis=2)
    else:
        o, lse = _replay(*leaves, N, causal=causal, window=window)
    (o * torch.from_numpy(do)).sum().backward()
    return o, lse, [o.detach().numpy()] + [t.grad.numpy() for t in leaves]


CASES = [("causal", dict(causal=True)), ("full", dict(causal=False)),
         ("window4", dict(causal=True, window=4)),
         ("window20", dict(causal=True, window=20)),
         ("window200", dict(causal=True, window=200)),
         ("striped", dict(causal=True, striped=True))]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_ring_replay_equals_jax_shard_map(sp_mesh, name, kw):
    q, k, v, do = _inputs(3)
    want = _jax_ring(sp_mesh, q, k, v, do, **kw)
    _, _, got = _port_ring(q, k, v, do, **kw)
    for label, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        tol = VALUE_TOL if label == "o" else GRAD_TOL
        np.testing.assert_allclose(g, w, err_msg=label, **tol)


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_ring_replay_lse_and_lse_cotangent(name, kw):
    """The merged lse is the full sequence's, and a cotangent on it (the
    lse of every hop then gets one through the merge) gives the full
    kernel's gradients."""
    q, k, v, do = _inputs(4)
    dl = np.random.default_rng(5).standard_normal(SHAPE[:3]) \
        .astype(np.float32)
    causal = kw["causal"]
    window = kw.get("window")
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o_ref, lse_ref = tflash.flash_attention_with_lse(
        *leaves, causal=causal, window=window)
    ((o_ref * torch.from_numpy(do)).sum()
     + (lse_ref * torch.from_numpy(dl)).sum()).backward()
    want = [o_ref.detach(), lse_ref.detach()] + [t.grad for t in leaves]
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    if kw.get("striped"):
        qs, ks, vs = (seq.stripe_tokens(t, N, axis=2) for t in leaves)
        o, lse = _replay(qs, ks, vs, N, causal=True, striped=True)
        o, lse = (seq.unstripe_tokens(t, N, axis=2) for t in (o, lse))
    else:
        o, lse = _replay(*leaves, N, causal=causal, window=window)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dl)).sum()).backward()
    got = [o.detach(), lse.detach()] + [t.grad for t in leaves]
    for label, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), label
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=label,
                                   **(VALUE_TOL if label in ("o", "lse")
                                      else GRAD_TOL))


@pytest.mark.parametrize("window", [4, 16, 20, 33, 200])
def test_windowed_ring_runs_jax_hop_count(sp_mesh, window, monkeypatch):
    """The hops that run (flash calls per rank) equal the JAX ring's
    static ``t_hi``, counted from its trace."""
    calls = []
    real = jflash_mod.flash_attention_with_lse

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(jflash_mod, "flash_attention_with_lse", counting)
    spec = JP(None, None, "sp", None)
    f = shard_map(lambda a, b_, c: jseq.ring_flash_attention(
        a, b_, c, axis_name="sp", causal=True, window=window, block_q=8,
        block_k=8), mesh=sp_mesh, in_specs=(spec, spec, spec),
        out_specs=spec, check_vma=False)
    x = jnp.zeros(SHAPE, jnp.float32)
    jax.eval_shape(f, x, x, x)
    jax_hops = len(calls)
    ported = []
    real_port = tflash.flash_attention_with_lse

    def port_counting(*a, **kw):
        ported.append(1)
        return real_port(*a, **kw)
    monkeypatch.setattr(tflash, "flash_attention_with_lse", port_counting)
    t = torch.zeros(SHAPE)
    s_loc = SHAPE[2] // N
    seq._ring_flash(t[:, :, :s_loc], t[:, :, :s_loc], t[:, :, :s_loc], 0, N,
                    lambda i, a, b_: (a, b_), causal=True, scale=None,
                    window=window)
    assert len(ported) == jax_hops == seq._window_hops(N, s_loc, window)


def test_stripe_tokens_equal_jax_and_round_trip():
    x = np.arange(2 * 16 * 3).reshape(2, 16, 3)
    for n in (1, 2, 4, 8):
        got = seq.stripe_tokens(torch.from_numpy(x), n, axis=1)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jseq.stripe_tokens(jnp.asarray(x), n,
                                                       axis=1)))
        np.testing.assert_array_equal(
            seq.unstripe_tokens(got, n, axis=1).numpy(), x)
    np.testing.assert_array_equal(
        seq.stripe_tokens(torch.arange(16), 4, axis=0).numpy(),
        [0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15])
    for fn in (seq.stripe_tokens, seq.unstripe_tokens):
        with pytest.raises(ValueError):
            fn(torch.arange(10), 4, axis=0)


def test_merge_lse_equals_jax():
    rng = np.random.default_rng(6)
    o_a, o_b = (rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
                for _ in range(2))
    l_a, l_b = (rng.standard_normal((2, 3, 5)).astype(np.float32) * 3
                for _ in range(2))
    l_b[0, 0] = seq._NEG                 # floor partials: weight zero
    l_a[1, 1] = l_b[1, 1] = seq._NEG     # both floor: finite, no NaN
    got = seq._merge_lse(*(torch.from_numpy(t) for t in (o_a, l_a, o_b,
                                                         l_b)))
    want = jseq._merge_lse(*(jnp.asarray(t) for t in (o_a, l_a, o_b, l_b)))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


REFUSALS = [
    ("unknown_core", dict(core="bogus"), None),
    ("window_dense", dict(core="dense", window=8), None),
    ("window_striped", dict(core="striped", window=8), None),
    ("striped_noncausal", dict(core="striped"), False),
]


@pytest.mark.parametrize("name,kw,causal", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_refusals_are_jax_value_errors(sp_mesh, name, kw, causal):
    from distributed_pytorch_tpu_torch.runtime import context
    x = torch.zeros(1, 2, 8, 8)
    xj = jnp.zeros((1, 2, 8, 8))
    kinds = []
    for build, mesh, arr in ((spmd.make_gspmd_ring_attn_fn,
                              context.get_mesh(), x),
                             (jspmd.make_gspmd_ring_attn_fn, sp_mesh, xj)):
        try:
            fn = build(mesh, **kw)
            fn(arr, arr, arr, causal=causal)
            kinds.append(None)
        except Exception as e:      # the kind of each package's refusal
            kinds.append(type(e))
    assert kinds == [ValueError, ValueError], kinds


def test_window_without_causal_and_ulysses_core_refused():
    x = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError):
        seq.ring_flash_attention(x, x, x, causal=False, window=4)
    with pytest.raises(ValueError):
        seq.ulysses_attention(x, x, x, core="bogus")
    with pytest.raises(ValueError):
        seq.ulysses_attention(x, x, x, causal=False, window=4)
    xj = jnp.zeros((1, 2, 8, 8))
    with pytest.raises(ValueError):
        jseq.ulysses_attention(xj, xj, xj, core="bogus")


def test_one_rank_ring_equals_attention():
    """Outside a group the rings have one hop: each equals the plain
    kernel / dense attention on the whole sequence."""
    from distributed_pytorch_tpu_torch.nn.attention import dense_attention
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(7))
    for causal in (False, True):
        want = dense_attention(q, k, v, causal=causal)
        for got in (seq.ring_attention(q, k, v, causal=causal),
                    seq.ring_flash_attention(q, k, v, causal=causal),
                    seq.ulysses_attention(q, k, v, causal=causal)):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       **VALUE_TOL)
    np.testing.assert_allclose(
        seq.striped_ring_flash_attention(q, k, v).numpy(),
        dense_attention(q, k, v, causal=True).numpy(), **VALUE_TOL)
