"""Training path of the PyTorch port against the JAX package.

Cross-entropy, the optimizers, the model's gradients (read back through
``convert.to_jax_params(grads=True)``), the remat policies and the
world-1 ``make_train_step`` are held to their JAX counterparts on the
same inputs and weights, in float32 on the CPU. Tolerances: |diff| <=
1e-5 on losses and gradients (float32, summation order only); 1e-6 on
parameters after optimizer updates of float32 parameters; one bfloat16
unit in the last place (relative 2^-7) for bfloat16 parameters, where
one float32 rounding difference can flip the final cast.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_pytorch_tpu as dist
from _torch_port import jax_and_port_lm, to_np
from distributed_pytorch_tpu import optim as joptim
from distributed_pytorch_tpu.ops.flash_attention import \
    make_flash_attn_fn as jax_flash_fn
from distributed_pytorch_tpu.ops.losses import cross_entropy as jax_ce
from distributed_pytorch_tpu.ops.losses import \
    cross_entropy_per_example as jax_ce_per_example
from distributed_pytorch_tpu.parallel import \
    make_train_step as jax_make_train_step
from distributed_pytorch_tpu_torch import optim, to_jax_params
from distributed_pytorch_tpu_torch.models import transformer as tlm
from distributed_pytorch_tpu_torch.ops.flash_attention import \
    make_flash_attn_fn
from distributed_pytorch_tpu_torch.ops.losses import (
    cross_entropy, cross_entropy_per_example)
from distributed_pytorch_tpu_torch.parallel import StepOutput, \
    make_train_step

jlm = importlib.import_module("distributed_pytorch_tpu.models.transformer")

TOL = 1e-5
VOCAB = 61

LM_CONFIGS = {
    "rope_gqa": dict(pos="rope", n_kv_heads=2),
    "learned_mha": dict(pos="learned", n_kv_heads=None),
}


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(got, want, atol):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0,
                                   err_msg=key)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape)


def _flash_lms(seed, **cfg):
    """JAX and port LMs with the same weights, both attending through
    their flash kernel (JAX interpret mode, port plain version)."""
    return jax_and_port_lm(
        seed=seed, jax_attn_fn=jax_flash_fn(block_q=16, block_k=16,
                                            min_seq_flash=None),
        port_attn_fn=make_flash_attn_fn(min_seq_flash=None), **cfg)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 7, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7))
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(
        cross_entropy_per_example(lt, yt).numpy(),
        np.asarray(jax_ce_per_example(jnp.asarray(logits),
                                      jnp.asarray(labels))), atol=TOL)
    np.testing.assert_allclose(float(cross_entropy(lt, yt)),
                               float(jax_ce(jnp.asarray(logits),
                                            jnp.asarray(labels))), atol=TOL)
    # bfloat16 logits: the log-sum-exp runs in float32 (the JAX function
    # on the float32 values of the same bfloat16 logits)
    lb = lt.to(torch.bfloat16)
    got = cross_entropy(lb, yt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jax_ce(
        jnp.asarray(lb.float().numpy()), jnp.asarray(labels))), atol=TOL)


def _param_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "emb": rng.standard_normal((7, 3)).astype(np.float32)}


OPTIMIZERS = {
    "adamw_f32": (lambda m: m.adamw(1e-2), np.float32),
    "adamw_bf16": (lambda m: m.adamw(1e-2), jnp.bfloat16),
    "adamw_wd": (lambda m: m.adamw(3e-3, b1=0.8, weight_decay=0.1),
                 np.float32),
    "sgd_momentum": (lambda m: m.sgd(0.1, momentum=0.9), np.float32),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    make, dtype = OPTIMIZERS[name]
    tree = _param_tree(1)
    keys = sorted(tree)
    jparams = {k: jnp.asarray(v, dtype) for k, v in tree.items()}
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tparams = [torch.from_numpy(tree[k]).to(tdtype) for k in keys]
    jopt, topt = make(joptim), make(optim)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in tree.items()}
        jparams, jstate = jopt.update(
            {k: jnp.asarray(g, dtype) for k, g in grads.items()}, jstate,
            jparams)
        tstate = topt.update([torch.from_numpy(grads[k]).to(tdtype)
                              for k in keys], tstate, tparams)
    for k, p in zip(keys, tparams):
        assert p.dtype == tdtype
        want = np.asarray(jparams[k]).astype(np.float32)
        if tdtype == torch.bfloat16:
            np.testing.assert_allclose(to_np(p), want, rtol=2 ** -7,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(to_np(p), want, atol=1e-6, rtol=0,
                                       err_msg=k)
    if name.startswith("adamw"):
        assert tstate.step == int(jstate.step) == 3
        for k, mu, nu in zip(keys, tstate.mu, tstate.nu):
            assert mu.dtype == nu.dtype == torch.float32
            np.testing.assert_allclose(mu.numpy(), np.asarray(jstate.mu[k]),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(nu.numpy(), np.asarray(jstate.nu[k]),
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(LM_CONFIGS))
def test_lm_grads_match_jax(name):
    jm, params, pm = _flash_lms(seed=3, **LM_CONFIGS[name])
    tokens = _tokens(4, (2, 33))
    x, y = tokens[:, :-1], tokens[:, 1:]

    def jax_loss(p):
        logits = jm.apply(p, jnp.asarray(x, jnp.int32)).astype(jnp.float32)
        return jax_ce(logits, jnp.asarray(y, jnp.int32))

    want_loss, want = jax.value_and_grad(jax_loss)(params)
    loss = cross_entropy(pm(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=TOL)
    _assert_trees_close(to_jax_params(pm, grads=True), want, atol=TOL)


def test_return_hidden_matches_jax():
    jm, params, pm = jax_and_port_lm(seed=5)
    x = _tokens(6, (2, 9))
    want = jm.apply(params, jnp.asarray(x, jnp.int32), return_hidden=True)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x), return_hidden=True)
    assert got.shape == (2, 9, pm.dim)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_remat_policies_give_equal_grads():
    """none / full / dots_saveable: the same gradients; ``full`` runs
    each block's attention forward twice (once more in backward)."""
    tokens = torch.from_numpy(_tokens(8, (2, 21)))
    x, y = tokens[:, :-1], tokens[:, 1:]
    grads, calls = {}, {}
    for policy in tlm.REMAT_POLICIES:
        count = []
        flash = make_flash_attn_fn(min_seq_flash=None)

        def attn_fn(q, k, v, **kw):
            count.append(1)
            return flash(q, k, v, **kw)

        _, _, pm = jax_and_port_lm(seed=7, pos="learned", remat=policy,
                                   port_attn_fn=attn_fn)
        assert pm.remat_policy == policy
        cross_entropy(pm(x), y).backward()
        grads[policy] = to_jax_params(pm, grads=True)
        calls[policy] = len(count)
    for policy in ("full", "dots_saveable"):
        _assert_trees_close(grads[policy], grads["none"], atol=1e-6)
    assert calls == {"none": 2, "full": 4, "dots_saveable": 4}


BAD_REMAT = ["bogus", "Full", "dots", 2, 0.5]


@pytest.mark.parametrize("value", BAD_REMAT)
def test_resolve_remat_rejects_like_jax(value):
    with pytest.raises(ValueError):
        jlm.resolve_remat(value)
    with pytest.raises(ValueError):
        tlm.resolve_remat(value)
    with pytest.raises(ValueError):
        tlm.apply_remat_policy(lambda x: x, value)


@pytest.mark.parametrize("value", [False, True, "none", "full",
                                   "dots_saveable", None])
def test_resolve_remat_accepts_like_jax(value, monkeypatch):
    monkeypatch.setenv("DPX_REMAT", "dots_saveable")
    assert tlm.resolve_remat(value) == jlm.resolve_remat(value)


def _train_loss_fn_jax(model):
    def loss_fn(p, batch):
        logits = model.apply(p, batch[:, :-1]).astype(jnp.float32)
        y = batch[:, 1:]
        return jax_ce(logits, y), {"correct": jnp.argmax(logits, -1) == y}
    return loss_fn


def _train_loss_fn_port(model, batch):
    logits = model(batch[:, :-1])
    y = batch[:, 1:].to(logits.device)
    return cross_entropy(logits, y), {"correct": logits.argmax(-1) == y}


@pytest.mark.parametrize("name", sorted(LM_CONFIGS))
def test_train_step_matches_jax(name):
    """A 3-step loss trajectory and the final params of the world-1 step,
    called as tests/test_data_parallel.py calls the JAX step.

    AdamW runs with eps=1e-4: with learned positions the key bias has an
    analytically zero gradient (a per-row shift of the logits), so its
    float32 gradient is rounding noise (~1e-9) that eps=1e-8 would blow
    up to a step of +-lr of either sign on each side."""
    jm, params, pm = _flash_lms(seed=9, **LM_CONFIGS[name])
    jopt, topt = joptim.adamw(1e-3, eps=1e-4), optim.adamw(1e-3, eps=1e-4)
    jparams = dist.replicate(params)
    jstate = dist.replicate(jopt.init(jparams))
    jstep = jax_make_train_step(_train_loss_fn_jax(jm), jopt)
    tstate = topt.init(pm.parameters())
    tstep = make_train_step(_train_loss_fn_port, topt)
    rng = np.random.default_rng(10)
    for _ in range(3):
        batch = rng.integers(0, VOCAB, (4, 17)).astype(np.int32)
        jparams, jstate, jloss, jmetrics = jstep(
            jparams, jstate, dist.shard_batch(jnp.asarray(batch)))
        out = tstep(pm, tstate, torch.from_numpy(batch))
        assert isinstance(out, StepOutput) and out.params is pm
        tstate = out.opt_state
        assert out.loss.shape == (1,) == np.asarray(jloss).shape
        np.testing.assert_allclose(out.loss.numpy(), np.asarray(jloss),
                                   atol=TOL)
        np.testing.assert_array_equal(out.metrics["correct"].numpy(),
                                      np.asarray(jmetrics["correct"]))
    _assert_trees_close(to_jax_params(pm), jparams, atol=TOL)


def test_train_step_rejects_unported_modes():
    """Every grad_reduce spelling and ZeRO-1 are ported (no
    NotImplementedError is left): at world 1 each trains, the quantized
    modes as the exact mean (JAX's ``n == 1``), and ZeRO-1 builds its
    own state; unknown spellings raise ValueError. (World > 1:
    tests/test_torch_grad_wire.py.)"""
    opt = optim.sgd(0.1)
    batch = torch.from_numpy(np.random.default_rng(3).integers(
        0, VOCAB, (4, 17)).astype(np.int32))
    ref = None
    for mode in ("mean", "quant", "int8", "q4", "adaptive"):
        model = jax_and_port_lm(seed=11)[2]
        step = make_train_step(_train_loss_fn_port, opt, grad_reduce=mode)
        step(model, opt.init(model.parameters()), batch)
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        ref = flat if ref is None else ref
        assert torch.equal(flat, ref), mode
    model = jax_and_port_lm(seed=11)[2]
    step = make_train_step(_train_loss_fn_port, opt, weight_update="sharded")
    step(model, step.init_opt_state(model.parameters()), batch)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    assert torch.equal(flat, ref)
    with pytest.raises(ValueError):
        make_train_step(_train_loss_fn_port, opt, grad_reduce="bogus")
    with pytest.raises(ValueError):
        make_train_step(_train_loss_fn_port, opt, weight_update="bogus")
    with pytest.raises(ValueError):
        make_train_step(_train_loss_fn_port, opt, mixed_precision="fp16")


@pytest.mark.parametrize("cfg", [dict(pos="learned"),
                                 dict(pos="none", tie_embeddings=True)],
                         ids=["learned", "tied"])
def test_to_jax_params_inverts_from_jax_params(cfg):
    _, params, pm = jax_and_port_lm(seed=13, **cfg)
    _assert_trees_close(to_jax_params(pm), params, atol=0)
    zeros = to_jax_params(pm, grads=True)
    assert all(not v.any() for v in _leaves(zeros).values())
