"""The ResNet-18 rung of the PyTorch port against the JAX package.

Same weights (JAX ``ResNet18.init`` converted by ``convert.py``), same
inputs (numpy, seeded). float32 is compared at rtol 1e-4 with an
absolute floor of 1e-5 x max(1, the largest entry of the tensor)
(summation order only): ``Conv2d``, ``BatchNorm2d`` in training and
eval mode, the pools, and ``ResNet18``'s logits and new BatchNorm
state, for both stems on 32x32 images.

This model's float32 gradients are ill-conditioned at small batches in
both packages: on some tensors each package's float32 gradient stands
1e-2 to 5e-2 (norm-relative) from its own float64 gradient, at inits
and inputs that differ from well-conditioned ones by a rounding, while
the two packages agree at float64 to ~1e-7. So gradients are compared
in float64 (rtol 1e-6, atol 1e-7 x scale), and the port's float32
gradient is held to be as accurate against JAX's float64 gradient as
JAX's own float32 gradient is. Steps of SGD carry gradient errors into
the parameters in proportion to the lr, and momentum at the example's
lr 0.05 grows them (a fourth loss at 32x32 stood 1.3e-2 from JAX's, the
first equal): float32 trajectories here run at lr 1e-3, where every
loss, parameter and running stat stays within the float32 tolerance,
and the three-step check at lr 0.05 runs in float64.

Also: a BatchNorm over one value per channel (N * H * W = 1), the eval
step, ``stack_state``, and over gloo at world 2: per-rank losses and
BatchNorm state against the JAX stateful step on the same two shards,
and SyncBatchNorm at world 2 equal to full-batch BatchNorm at world 1.
Serial run time ~70 s (two spawned gloo runs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_pytorch_tpu as jdist
from _torch_port import CPU, launch_cpu_ranks
from distributed_pytorch_tpu import data as jdata
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu import optim as joptim
from distributed_pytorch_tpu.nn import conv as jconv
from distributed_pytorch_tpu.ops.losses import \
    cross_entropy_per_example as jax_ce
from distributed_pytorch_tpu.parallel import (
    make_stateful_eval_step as jax_make_stateful_eval_step)
from distributed_pytorch_tpu.parallel import (
    make_stateful_train_step as jax_make_stateful_train_step)
from distributed_pytorch_tpu.parallel import stack_state as jax_stack_state
from distributed_pytorch_tpu_torch import (ResNet18, from_jax_params,
                                           from_jax_state, to_jax_params,
                                           to_jax_state)
from distributed_pytorch_tpu_torch.examples import train_resnet
from distributed_pytorch_tpu_torch.nn import (BatchNorm2d, Conv2d,
                                              global_avg_pool, max_pool)
from distributed_pytorch_tpu_torch.ops.losses import cross_entropy
from distributed_pytorch_tpu_torch.optim import sgd
from distributed_pytorch_tpu_torch.parallel import (make_stateful_eval_step,
                                                    make_stateful_train_step,
                                                    stack_state)

RTOL, ATOL = 1e-4, 1e-5
LR, MOMENTUM = 1e-3, 0.9


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    """Every leaf within ``rtol`` of ``want``, or ``atol`` x max(1, the
    leaf's largest entry)."""
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        w = np.asarray(w, np.float64)
        scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=rtol,
                                   atol=atol * scale,
                                   err_msg=jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def _jax_init(small_input):
    """The JAX model's (params, state) from ``PRNGKey(0)``, as numpy."""
    jm = jmodels.ResNet18(n_classes=10, small_input=small_input)
    return _np(jax.jit(jm.init)(jax.random.PRNGKey(0)))


def _pair(small_input):
    """(JAX model, params, state, port model with the same weights)."""
    jm = jmodels.ResNet18(n_classes=10, small_input=small_input)
    params, state = _jax_init(small_input)
    pm = ResNet18(n_classes=10, small_input=small_input, device=CPU)
    from_jax_params(params, pm)
    from_jax_state(state, pm)
    return jm, params, state, pm


def _images(n, hw, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, hw, hw, 3), dtype=np.float32),
            rng.integers(0, 10, (n,)).astype(np.int32))


@pytest.mark.parametrize("cfg", [dict(kernel=3, stride=1, padding=1),
                                 dict(kernel=7, stride=2, padding=3),
                                 dict(kernel=1, stride=2, padding=0),
                                 dict(kernel=3, stride=1, padding=1,
                                      bias=True, groups=2)],
                         ids=["3x3s1", "7x7s2", "1x1s2", "bias_groups2"])
def test_conv2d_matches_jax(cfg):
    jc = jconv.Conv2d(4, 6, **cfg)
    p = jc.init(jax.random.PRNGKey(1))
    if "b" in p:
        p["b"] = jnp.arange(6, dtype=jnp.float32) / 7
    tc = Conv2d(4, 6, device=CPU, **cfg)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(np.asarray(p["w"]).transpose(
            3, 2, 0, 1)))
        if tc.bias is not None:
            tc.bias.copy_(torch.from_numpy(np.asarray(p["b"])))
    x = np.random.default_rng(2).standard_normal((2, 9, 9, 4)).astype(
        np.float32)
    np.testing.assert_allclose(_nhwc(tc(_nchw(x))), np.asarray(jc.apply(p, x)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("axis_name", [None, "dp"], ids=["local", "sync_w1"])
def test_batchnorm_train_and_eval_match_jax(axis_name):
    """Training mode: output and new running stats; eval mode: output
    from the running stats, state unchanged. ``axis_name`` at world 1 is
    the sum / sum-of-squares formula on the local batch in both."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 5, 4, 3)) * 3 + 1).astype(np.float32)
    jb = jconv.BatchNorm2d(3, axis_name=axis_name)
    p = {"scale": jnp.asarray([1.5, 0.5, 2.0]),
         "bias": jnp.asarray([0.1, -0.2, 0.3])}
    state = jb.init_state()
    y_tr, s_tr = jb.apply(p, x, state=state, train=True)
    y_ev, s_ev = jb.apply(p, x, state=s_tr, train=False)

    tb = BatchNorm2d(3, axis_name=axis_name, device=CPU)
    with torch.no_grad():
        tb.scale.copy_(torch.tensor([1.5, 0.5, 2.0]))
        tb.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    tb.train()
    np.testing.assert_allclose(_nhwc(tb(_nchw(x))), np.asarray(y_tr),
                               rtol=RTOL, atol=ATOL)
    got = {k: getattr(tb, k).numpy().copy() for k in ("mean", "var", "count")}
    _assert_trees_close(got, _np(s_tr))
    assert tb.count.dtype == torch.int32 and int(tb.count) == 1
    tb.eval()
    np.testing.assert_allclose(_nhwc(tb(_nchw(x))), np.asarray(y_ev),
                               rtol=RTOL, atol=ATOL)
    _assert_trees_close({k: getattr(tb, k).numpy() for k in got}, _np(s_ev))


def test_pools_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 7, 7, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(_nhwc(max_pool(_nchw(x), 3, 2, padding=1)),
                                  np.asarray(jconv.max_pool(x, 3, 2, 1)))
    np.testing.assert_allclose(global_avg_pool(_nchw(x)).numpy(),
                               np.asarray(jconv.global_avg_pool(x)),
                               rtol=RTOL, atol=ATOL)


def _jax_loss_and_grads(jm, params, state, x, y):
    def loss_fn(p, st):
        logits, ns = jm.apply(p, x, state=st, train=True)
        return jax_ce(logits, y).mean(), (logits, ns)
    (loss, (logits, ns)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, state)
    return loss, logits, ns, grads


def _port_loss_and_grads(pm, x, y):
    pm.train()
    logits = pm(torch.from_numpy(x))
    loss = cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return loss, logits


def _to64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a,
        tree)


def _grad_rel_errs(got, want):
    """||got - want|| / ||want|| per leaf of two gradient trees."""
    return {jax.tree_util.keystr(p): float(
        np.linalg.norm(np.asarray(g, np.float64) - w)
        / max(np.linalg.norm(w), 1e-30)) for (p, g), (_, w) in zip(
        jax.tree_util.tree_leaves_with_path(got),
        jax.tree_util.tree_leaves_with_path(want))}


@pytest.mark.parametrize("small_input,batch", [(True, 4), (False, 16)],
                         ids=["cifar_stem", "imagenet_stem"])
def test_resnet18_logits_grads_and_state_match_jax(small_input, batch):
    """32x32 images. float32 logits and new BatchNorm state at RTOL /
    ATOL; gradients in float64 at rtol 1e-6, atol 1e-7 x scale; and each
    float32 gradient as close, in norm, to JAX's float64 gradient as
    JAX's own float32 gradient is (3x, with a floor of 1e-5): both
    packages' float32 gradients stand up to ~5e-2 from float64 here
    (module docstring)."""
    jm, params, state, pm = _pair(small_input)
    x, y = _images(batch, 32, seed=6)
    loss, logits, ns, grads = _jax_loss_and_grads(jm, params, state, x, y)
    t_loss, t_logits = _port_loss_and_grads(pm, x, y)
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(logits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=RTOL)
    _assert_trees_close(to_jax_state(pm), _np(ns))
    grads32 = to_jax_params(pm, grads=True)

    with jax.enable_x64(True):
        _, logits64, ns64, g64 = _jax_loss_and_grads(
            jm, _to64(params), _to64(state), x.astype(np.float64), y)
        logits64, ns64, g64 = np.asarray(logits64), _np(ns64), _np(g64)
    pm64 = ResNet18(small_input=small_input, device=CPU, dtype=torch.float64)
    pm64.to(torch.float64)               # the running stats too
    from_jax_params(_np(params), pm64)
    _, t_logits64 = _port_loss_and_grads(pm64, x.astype(np.float64), y)
    np.testing.assert_allclose(t_logits64.detach().numpy(), logits64,
                               rtol=1e-6, atol=1e-7)
    _assert_trees_close(to_jax_params(pm64, grads=True), g64, rtol=1e-6,
                        atol=1e-7)
    _assert_trees_close(to_jax_state(pm64), ns64, rtol=1e-6, atol=1e-7)

    port_err = _grad_rel_errs(grads32, g64)
    jax_err = _grad_rel_errs(_np(grads), g64)
    for k, err in port_err.items():
        assert err <= 3 * jax_err[k] + 1e-5, (k, err, jax_err[k])


def test_one_value_per_channel_batchnorm_matches_jax():
    """N * H * W = 1: the ImageNet stem on one 32x32 image leaves stage 4
    at 1x1, where ``F.batch_norm`` would refuse the batch. The batch var
    is 0, so the running var becomes 0.9 * 1 + 0.1 * 0."""
    jm, params, state, pm = _pair(False)
    x, y = _images(1, 32, seed=10)
    _, logits, ns, _ = _jax_loss_and_grads(jm, params, state, x, y)
    _, t_logits = _port_loss_and_grads(pm, x, y)
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(logits),
                               rtol=RTOL, atol=ATOL)
    _assert_trees_close(to_jax_state(pm), _np(ns))
    np.testing.assert_allclose(to_jax_state(pm)["s3b1"]["bn2"]["var"], 0.9,
                               rtol=1e-6)
    bn = BatchNorm2d(4, device=CPU)
    out = bn(torch.ones(1, 4, 1, 1))
    assert torch.equal(out, torch.zeros(1, 4, 1, 1))
    np.testing.assert_allclose(bn.var.numpy(), 0.9, rtol=1e-6)


def _resnet_loss_port(model, batch):
    x, y = batch
    return cross_entropy(model(x), y), {}


def test_stateful_step_three_sgd_steps_match_jax():
    """At the example's lr 0.05 with momentum 0.9, in float64 on both
    sides (module docstring: float32 would measure the gradients'
    conditioning, not the step). Even float64 rounding grows to ~1e-7
    of a parameter by the third step (seen 1.1e-7 on one stem weight),
    so parameters and stats are held to rtol 1e-5, atol 1e-6 x scale;
    a wrong momentum, lr or variance would miss them by far more."""
    lr = 0.05
    jm, init, state, _ = _pair(True)
    with jax.enable_x64(True):
        params, state = _to64((init, state))
        jopt = joptim.sgd(lr, momentum=MOMENTUM)

        def loss_fn(p, st, batch):
            x, y = batch
            logits, ns = jm.apply(p, x, state=st, train=True)
            return jax_ce(logits, y).mean(), (ns, {})

        jstep = jax_make_stateful_train_step(loss_fn, jopt, donate=False)
        jostate = jopt.init(params)
        want = []
        for t in range(3):
            x, y = _images(4, 16, seed=20 + t)
            params, state, jostate, jloss, _ = jstep(
                params, state, jostate, (x.astype(np.float64), y))
            want.append((np.asarray(jloss), _np(params), _np(state)))

    pm = ResNet18(small_input=True, device=CPU, dtype=torch.float64)
    pm.to(torch.float64)                 # the running stats too
    from_jax_params(init, pm)
    opt = sgd(lr, momentum=MOMENTUM)
    step = make_stateful_train_step(_resnet_loss_port, opt)
    ostate = opt.init(pm.parameters())
    pm.eval()                               # the step trains, then restores
    for t, (jloss, jparams, jstate) in enumerate(want):
        x, y = _images(4, 16, seed=20 + t)
        out = step(pm, ostate, (torch.from_numpy(x).double(),
                                torch.from_numpy(y)))
        ostate = out.opt_state
        assert not pm.training
        np.testing.assert_allclose(out.loss.numpy(), jloss, rtol=1e-6)
        _assert_trees_close(to_jax_params(pm), jparams, rtol=1e-5, atol=1e-6)
        _assert_trees_close(to_jax_state(pm), jstate, rtol=1e-5, atol=1e-6)
        assert out.state["bn_stem.count"] is pm.bn_stem.count
        assert int(out.state["bn_stem.count"]) == t + 1


def test_eval_step_matches_jax_and_leaves_state_alone():
    jm, params, state, pm = _pair(True)
    x, y = _images(6, 16, seed=13)
    # running stats from one training forward
    _, _, state, _ = _jax_loss_and_grads(jm, params, state, x, y)
    _port_loss_and_grads(pm, x, y)

    def jeval(p, st, batch):
        logits, _ = jm.apply(p, batch[0], state=st, train=False)
        return logits

    def peval(model, batch):
        return model(batch[0])

    want = jax_make_stateful_eval_step(jeval)(params, state, (x, y))
    before = {k: v.clone() for k, v in pm.named_buffers()}
    pm.train()
    got = make_stateful_eval_step(peval)(pm, (torch.from_numpy(x),))
    assert pm.training and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for k, v in pm.named_buffers():
        assert torch.equal(v, before[k]), k


def test_stack_state_matches_jax():
    _, _, state, pm = _pair(True)
    got = stack_state(dict(pm.named_buffers()), 2)
    assert got["s0b0.bn1.mean"].shape == (2, 64)
    assert got["bn_stem.count"].shape == (2,)
    want = _np(jax_stack_state(state, 2))
    np.testing.assert_array_equal(got["s0b0.bn1.var"].numpy(),
                                  want["s0b0"]["bn1"]["var"])


# -- world 2 over gloo ----------------------------------------------------

W2_ARGS = ["--device", "cpu", "--lr", str(LR), "--epochs", "1",
           "--limit-steps", "2", "--data-size", "32", "--batch-size", "4"]


def _run_w2(tmp_path, extra, init_params):
    launch_cpu_ranks(train_resnet.main_worker, 2, W2_ARGS + extra, True,
                     None, str(tmp_path), init_params)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def test_world2_gloo_matches_jax_stateful_step_per_rank(tmp_path):
    """Each rank's losses and BatchNorm state against the JAX stateful
    step at world 2 on the same two shards (the JAX loader's global batch
    is the ranks' local batches in rank order)."""
    jm, params, state, _ = _pair(True)
    ranks = _run_w2(tmp_path, [], _np(params))

    jdist.init_process_group(0, 2)
    jopt = joptim.sgd(LR, momentum=MOMENTUM)

    def loss_fn(p, st, batch):
        x, y = batch
        logits, ns = jm.apply(p, x, state=st, train=True)
        return jax_ce(logits, y).mean(), (ns, {})

    step = jax_make_stateful_train_step(loss_fn, jopt, donate=False)
    data = jdata.SyntheticImages(32)
    loader = jdata.DataLoader(data, batch_size=4, drop_last=True,
                              sampler=jdist.data_sampler(data, True,
                                                         shuffle=True))
    p, o = jdist.replicate(params), jdist.replicate(jopt.init(params))
    st = jdist.shard_batch(jax_stack_state(state, 2))
    losses = []
    for batch, _ in zip(loader, range(2)):
        p, st, o, loss, _ = step(p, st, o, jdist.shard_batch(batch))
        losses.append(np.asarray(loss))
    losses = np.stack(losses)                      # (steps, world)
    for r, rec in enumerate(ranks):
        np.testing.assert_allclose(rec["local_losses"], losses[:, r],
                                   rtol=RTOL)
        want = jax.tree_util.tree_map(lambda a: np.asarray(a)[r], st)
        _assert_trees_close(rec["state"], want)


def test_sync_bn_world2_equals_full_batch_world1(tmp_path):
    """``--sync-bn`` at world 2, per-rank batch 4: the same 8 images per
    step as world 1 at batch 8 (the sampler's and the shuffling loader's
    permutations are one), so the losses and every rank's running stats
    equal the full-batch run's."""
    ranks = _run_w2(tmp_path, ["--sync-bn"], None)
    full = train_resnet.main_worker(
        0, 1, W2_ARGS[:-1] + ["8"], quiet=True)
    for rec in ranks:
        np.testing.assert_allclose(rec["losses"], full["losses"], rtol=RTOL)
        _assert_trees_close(rec["state"], full["state"])
    _assert_trees_close(ranks[0]["state"], ranks[1]["state"], rtol=0,
                        atol=0)
