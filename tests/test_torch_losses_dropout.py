"""The fused vocab-projection loss and dropout of the PyTorch port.

``fused_linear_cross_entropy`` against the JAX package's (the same
hidden states, weight and labels; the port takes the weight as (vocab,
d), JAX as (d, vocab)) and against the plain cross-entropy of the
materialized logits, in value and both gradients, over chunkings that
divide the rows, leave a ragged last chunk, or take all rows at once.
float32 limits: value rtol 1e-6, gradients rtol 1e-5 with an absolute
floor of 1e-7 (summation order only, the JAX test's own limits).
bfloat16 inputs: the value against the plain loss of the same inputs in
float32 (rtol 1e-6: the chunk logits are float32 sums of exact
products), the gradients in bfloat16 within 1e-2 of it (norm-relative:
the softmax gradient and each result are rounded to bfloat16 once).

Dropout: at rate 0.0 the model is unchanged bit for bit (logits and
gradients); above it the kept share lies within 5 standard deviations
of ``1 - rate`` and every kept value is ``x / (1 - rate)`` exactly; a
seeded generator repeats its masks, and under ``remat="full"`` the
recomputed forward draws the same masks (equal gradients). Also
``Sequential`` and ``relu`` against the JAX package's. Serial run time
~10 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, small_lm_kwargs
from distributed_pytorch_tpu.nn import core as jcore
from distributed_pytorch_tpu.ops.losses import \
    fused_linear_cross_entropy as jax_fused
from distributed_pytorch_tpu_torch import TransformerLM
from distributed_pytorch_tpu_torch.nn import (Dropout, Linear, Sequential,
                                              relu)
from distributed_pytorch_tpu_torch.ops.losses import (
    cross_entropy, fused_linear_cross_entropy)


def _inputs(n=37, d=16, v=53, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((v, d)) * 0.1).astype(np.float32),
            rng.integers(0, v, (n,)).astype(np.int32))


def _port(fn, h, w, y):
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = fn(ht, wt, torch.from_numpy(y))
    loss.backward()
    return loss.detach(), ht.grad, wt.grad


@pytest.mark.parametrize("chunk", [8, 37, 1024, 5, 1],
                         ids=["ragged8", "exact37", "single1024", "ragged5",
                              "rows1"])
def test_fused_ce_matches_jax_and_the_plain_loss(chunk):
    h, w, y = _inputs()
    loss, gh, gw = _port(lambda a, b, c: fused_linear_cross_entropy(
        a, b, c, chunk_rows=chunk), h, w, y)
    jloss, (jgh, jgw) = jax.value_and_grad(
        lambda a, b: jax_fused(a, b, y, chunk_rows=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w.T))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw).T, rtol=1e-5,
                               atol=1e-7)
    ploss, pgh, pgw = _port(lambda a, b, c: cross_entropy(a @ b.T, c), h, w,
                            y)
    np.testing.assert_allclose(loss.item(), ploss.item(), rtol=1e-6)
    np.testing.assert_allclose(gh.numpy(), pgh.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gw.numpy(), pgw.numpy(), rtol=1e-5, atol=1e-7)


def test_fused_ce_batched_shape_matches_jax():
    h, w, y = _inputs(n=24)
    got = fused_linear_cross_entropy(torch.from_numpy(h).reshape(4, 6, -1),
                                     torch.from_numpy(w),
                                     torch.from_numpy(y).reshape(4, 6),
                                     chunk_rows=7)
    want = jax_fused(jnp.asarray(h).reshape(4, 6, -1), jnp.asarray(w.T),
                     jnp.asarray(y).reshape(4, 6), chunk_rows=7)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _rel(a, b):
    a, b = a.to(torch.float32), b.to(torch.float32)
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("chunk", [8, 64])
def test_fused_ce_bf16_has_float32_chunk_logits(chunk):
    h, w, y = _inputs(n=64, d=32, v=101, seed=1)
    hb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (h, w))
    loss, gh, gw = _port(lambda a, b, c: fused_linear_cross_entropy(
        a, b, c, chunk_rows=chunk), hb.float().numpy(), wb.float().numpy(), y)
    ht, wt = (t.clone().requires_grad_(True) for t in (hb, wb))
    bl = fused_linear_cross_entropy(ht, wt, torch.from_numpy(y),
                                    chunk_rows=chunk)
    bl.backward()
    assert ht.grad.dtype == wt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(bl.item(), loss.item(), rtol=1e-6)
    assert _rel(ht.grad, gh) <= 1e-2 and _rel(wt.grad, gw) <= 1e-2


def test_fused_ce_on_the_lm_equals_the_logits_path():
    kw = small_lm_kwargs(vocab=64, max_seq=16)
    model = TransformerLM(device=CPU, generator=torch.Generator()
                          .manual_seed(0), **kw)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (2, 17)))
    hid = model(toks[:, :-1], return_hidden=True)
    fused = fused_linear_cross_entropy(hid, model.head_weight(), toks[:, 1:],
                                       chunk_rows=8)
    plain = cross_entropy(model(toks[:, :-1]), toks[:, 1:])
    np.testing.assert_allclose(fused.item(), plain.item(), rtol=1e-6)


# -- dropout --------------------------------------------------------------


def test_dropout_zero_is_bit_exact():
    kw = small_lm_kwargs()
    base = TransformerLM(device=CPU, generator=torch.Generator()
                         .manual_seed(3), **kw)
    drop0 = TransformerLM(device=CPU, dropout=0.0, **kw)
    drop0.load_state_dict(base.state_dict())
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 61, (2, 9)))
    base.train()
    drop0.train()
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    outs = []
    for model, g in ((base, None), (drop0, gen)):
        logits = model(toks, generator=g)
        logits.float().sum().backward()
        outs.append((logits.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert torch.equal(gen.get_state(), state)       # nothing drawn


def test_dropout_keep_rate_and_scale():
    rate = 0.3
    drop = Dropout(rate)
    x = torch.rand(400, 500) + 0.5
    assert drop.eval()(x, generator=torch.Generator()) is x
    drop.train()
    assert drop(x) is x                               # no generator
    assert Dropout(0.0).train()(x, torch.Generator()) is x
    out = drop(x, generator=torch.Generator().manual_seed(1))
    kept = out != 0
    n, keep = x.numel(), 1 - rate
    share = kept.float().mean().item()
    assert abs(share - keep) <= 5 * np.sqrt(keep * rate / n)
    assert torch.equal(out[kept], x[kept] / keep)
    again = drop(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(out, again)
    other = drop(x, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(out, other)


def test_lm_dropout_masks_follow_the_generator_and_survive_remat():
    kw = small_lm_kwargs(max_seq=32)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 61, (2, 12)))
    ref = TransformerLM(device=CPU, dropout=0.2, generator=torch.Generator()
                        .manual_seed(6), **kw)
    remat = TransformerLM(device=CPU, dropout=0.2, remat="full", **kw)
    remat.load_state_dict(ref.state_dict())
    grads = []
    for model in (ref, remat):
        model.train()
        out = model(toks, generator=torch.Generator().manual_seed(7))
        out.float().square().mean().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    ref.eval()
    with torch.no_grad():
        clean = ref(toks, generator=torch.Generator().manual_seed(7))
        ref.train()
        d1 = ref(toks, generator=torch.Generator().manual_seed(7))
        d2 = ref(toks, generator=torch.Generator().manual_seed(8))
    assert not torch.equal(clean, d1) and not torch.equal(d1, d2)


class _Relu(torch.nn.Module):
    def forward(self, x):
        return relu(x)


def test_sequential_and_relu_match_jax():
    """Named layers in order, each registered under its name (the JAX
    param tree's keys)."""
    jseq = jcore.Sequential([("a", jcore.Linear(4, 8)),
                             ("b", jcore.Linear(8, 3))])
    params = jax.tree_util.tree_map(np.asarray,
                                    jseq.init(jax.random.PRNGKey(0)))
    seq = Sequential([("a", Linear(4, 8, device=CPU)), ("relu", _Relu()),
                      ("b", Linear(8, 3, device=CPU))])
    assert [n for n, _ in seq.named_children()] == ["a", "relu", "b"]
    with torch.no_grad():
        for name in ("a", "b"):
            getattr(seq, name).weight.copy_(torch.from_numpy(
                params[name]["w"].T.copy()))
            getattr(seq, name).bias.copy_(torch.from_numpy(
                params[name]["b"]))
    x = np.random.default_rng(9).standard_normal((5, 4)).astype(np.float32)
    p = params
    want = jcore.relu(x @ p["a"]["w"] + p["a"]["b"]) @ p["b"]["w"] \
        + p["b"]["b"]
    np.testing.assert_allclose(seq(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    v = np.linspace(-2, 2, 9, dtype=np.float32)
    np.testing.assert_array_equal(relu(torch.from_numpy(v)).numpy(),
                                  np.asarray(jcore.relu(v)))
