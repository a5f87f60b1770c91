"""The LM rung's optimizer stack of the PyTorch port against the JAX
package: the schedules, the wrappers (``with_schedule``,
``with_clipping``, ``accumulate``, ``with_ema``, ``with_master_f32``),
``adafactor``, ``adamw_8bit`` and ``make_scan_train_steps``.

Parameters and gradients are seeded numpy arrays handed to both sides
(a JAX list pytree, the port's list of tensors). Limits: schedules rtol
1e-6; float32 parameters and optimizer state after every one of 5 steps
rtol 1e-6 with an absolute floor of 1e-7 (the JAX package's order of
float32 operations, kept by the port; elements whose update cancels to
~0 get the floor); bfloat16 parameters equal bit for bit (the same
float32 value rounded once). ``adamw_8bit``: its linear first-moment
codes equal JAX's bit for bit (both round half to even); its log-domain
second-moment codes within 1 of JAX's (``log`` may differ in the last
bit), so the dequantized moments within one code step; parameters after
5 steps within the JAX test's own limit, 0.1 of the total update, of
JAX's 8-bit run and of float32 ``adamw``. Serial run time ~5 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import optim as joptim
from distributed_pytorch_tpu_torch import optim
from distributed_pytorch_tpu_torch.models import DummyModel
from distributed_pytorch_tpu_torch.ops.losses import cross_entropy
from distributed_pytorch_tpu_torch.parallel import (make_scan_train_steps,
                                                    make_train_step)

SHAPES = [(16, 32), (32,), (3, 4, 5)]
STEPS = 5
RTOL, ATOL = 1e-6, 1e-7
JBF16 = jnp.bfloat16


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]


def _leaves(state):
    """The arrays of a port state nest in the JAX tree's leaf order."""
    if isinstance(state, torch.Tensor):
        return [state.detach().to(torch.float32).numpy()]
    if isinstance(state, (int, float)):
        return [np.asarray(state)]
    if isinstance(state, (tuple, list)):
        return [leaf for x in state for leaf in _leaves(x)]
    raise TypeError(type(state))


def _run(jopt, popt, dtype="float32", steps=STEPS, grad_scale=0.1):
    """Both optimizers over ``steps`` seeded gradient steps; yields each
    step's (JAX params, JAX state, port params, port state)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (JBF16, torch.bfloat16)}[dtype]
    init = _arrays(0, 0.3)
    jp = [jnp.asarray(a, jdt) for a in init]
    tp = [torch.from_numpy(a).to(tdt) for a in init]
    js, ts = jopt.init(jp), popt.init(tp)
    for t in range(steps):
        grads = _arrays(100 + t, grad_scale)
        jp, js = jopt.update([jnp.asarray(g, jdt) for g in grads], js, jp)
        ts = popt.update([torch.from_numpy(g).to(tdt) for g in grads], ts, tp)
        yield jp, js, tp, ts


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            g = g.detach().to(torch.float32).numpy()
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=rtol,
                                   atol=atol)


def _check_trajectory(jopt, popt, **kw):
    for jp, js, tp, ts in _run(jopt, popt, **kw):
        _close(tp, jp)
        _close(_leaves(ts), jax.tree_util.tree_leaves(js))


@pytest.mark.parametrize("name", ["constant", "linear_warmup", "cosine_decay",
                                  "cosine_decay_alpha", "warmup_cosine"])
def test_schedules_match_jax(name):
    def build(m):
        return {"constant": lambda: m.constant(3e-4),
                "linear_warmup": lambda: m.linear_warmup(m.constant(2.0), 7),
                "cosine_decay": lambda: m.cosine_decay(1.0, 20),
                "cosine_decay_alpha": lambda: m.cosine_decay(0.5, 13, 0.1),
                "warmup_cosine": lambda: m.warmup_cosine(3e-4, 2, 12)}[name]()
    js, ps = build(joptim), build(optim)
    for step in range(0, 25):
        np.testing.assert_allclose(ps(step), float(js(step)), rtol=RTOL,
                                   err_msg=f"step {step}")
    with pytest.raises(ValueError, match="decay_steps"):
        optim.cosine_decay(1.0, 0)


@pytest.mark.parametrize("base", ["adamw", "sgd_momentum"])
def test_with_schedule_matches_jax(base):
    sched = (0.5, 3, 9)

    def make(m):
        f = m.adamw if base == "adamw" else (
            lambda lr: m.sgd(lr, momentum=0.9))
        return m.with_schedule(f, m.warmup_cosine(*sched))
    _check_trajectory(make(joptim), make(optim))


def test_with_schedule_bf16_rounds_as_jax():
    """bfloat16 parameters, one step: JAX returns the float32 value of
    ``p + lr * (p_unit - p)`` (its float32 lr promotes), which the port
    rounds into the bfloat16 parameter once."""
    jopt = joptim.with_schedule(joptim.adamw, joptim.constant(3e-2))
    popt = optim.with_schedule(optim.adamw, optim.constant(3e-2))
    jp, _, tp, _ = next(_run(jopt, popt, "bfloat16", steps=1))
    for g, w in zip(tp, jp):
        assert g.dtype == torch.bfloat16
        want = np.asarray(jnp.asarray(w).astype(JBF16).astype(jnp.float32))
        np.testing.assert_array_equal(g.to(torch.float32).numpy(), want)


def test_with_schedule_rejects_master_inside():
    params = [torch.ones(4)]
    bad = optim.with_schedule(lambda lr: optim.with_master_f32(
        optim.adamw(lr)), optim.constant(1e-3))
    with pytest.raises(ValueError, match="with_master_f32"):
        bad.init(params)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "passes"])
def test_with_clipping_matches_jax(max_norm):
    _check_trajectory(joptim.with_clipping(joptim.adamw(1e-2), max_norm),
                      optim.with_clipping(optim.adamw(1e-2), max_norm))
    grads = [torch.from_numpy(g) for g in _arrays(7, 3.0)]
    want = joptim.clip_by_global_norm([jnp.asarray(g.numpy())
                                       for g in grads], max_norm)
    _close(optim.clip_by_global_norm(grads, max_norm), want)
    np.testing.assert_allclose(
        optim.global_norm(grads).item(),
        float(joptim.schedules.global_norm([jnp.asarray(g.numpy())
                                            for g in grads])), rtol=RTOL)


def test_accumulate_every_3_matches_jax_and_the_big_batch():
    """6 micro-steps with every=3 against JAX, and 3 micro-gradients
    accumulated equal one step on their mean."""
    _check_trajectory(joptim.accumulate(joptim.adamw(1e-2), every=3),
                      optim.accumulate(optim.adamw(1e-2), every=3), steps=6)
    micro = [_arrays(100 + t, 0.1) for t in range(3)]
    mean = [np.mean([m[i] for m in micro], axis=0) for i in range(3)]
    acc, plain = optim.accumulate(optim.adamw(1e-2), every=3), \
        optim.adamw(1e-2)
    pa = [torch.from_numpy(a) for a in _arrays(0, 0.3)]
    pb = [p.clone() for p in pa]
    sa = acc.init(pa)
    for t, g in enumerate(micro):
        before = [p.clone() for p in pa]
        sa = acc.update([torch.from_numpy(x) for x in g], sa, pa)
        if t < 2:                                   # passes through
            assert all(torch.equal(a, b) for a, b in zip(pa, before))
    plain.update([torch.from_numpy(x) for x in mean], plain.init(pb), pb)
    _close(pa, [p.numpy() for p in pb], rtol=RTOL, atol=1e-7)
    assert sa.count == 0 and all(not a.any() for a in sa.acc)
    with pytest.raises(ValueError, match="every"):
        optim.accumulate(optim.sgd(1.0), every=0)


@pytest.mark.parametrize("base", ["adamw", "sgd"])
def test_with_ema_matches_jax(base):
    def make(m):
        inner = m.adamw(1e-2) if base == "adamw" else m.sgd(0.5)
        return m.with_ema(inner, decay=0.9)
    _check_trajectory(make(joptim), make(optim))


def test_with_ema_and_master_copies_are_not_aliases():
    """float32 parameters: ``p.float()`` is ``p``, so an EMA or master
    that aliased it would move with the in-place update."""
    for wrap in (lambda o: optim.with_ema(o, 0.9), optim.with_master_f32):
        params = [torch.from_numpy(a) for a in _arrays(0, 0.3)]
        opt = wrap(optim.adamw(1e-2))
        st = opt.init(params)
        copies = st.ema if hasattr(st, "ema") else st.master
        assert all(c.data_ptr() != p.data_ptr()
                   for c, p in zip(copies, params))
        st = opt.update([torch.from_numpy(g) for g in _arrays(100, 0.1)], st,
                        params)
        copies = st.ema if hasattr(st, "ema") else st.master
        if hasattr(st, "ema"):
            assert not any(torch.equal(c, p) for c, p in zip(copies, params))
        else:
            assert all(torch.equal(c, p) for c, p in zip(copies, params))
            assert all(c.data_ptr() != p.data_ptr()
                       for c, p in zip(copies, params))


def test_ema_params_nested_and_like():
    opt = optim.with_clipping(optim.with_ema(optim.adamw(1e-2), 0.5), 1.0)
    params = [torch.ones(4, dtype=torch.bfloat16)]
    st = opt.init(params)
    st = opt.update([torch.ones(4, dtype=torch.bfloat16)], st, params)
    out = optim.ema_params(st, like=params)
    assert out[0].dtype == torch.bfloat16
    assert out[0].data_ptr() != st.ema[0].data_ptr()
    assert optim.ema_params(st)[0].dtype == torch.float32
    with pytest.raises(ValueError, match="no EmaState"):
        optim.ema_params(optim.adamw(1e-2).init(params))
    with pytest.raises(ValueError, match="decay"):
        optim.with_ema(optim.sgd(0.1), decay=1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_with_master_f32_over_with_schedule_matches_jax(dtype):
    """The documented composition: float32 masters, bfloat16 working
    parameters their cast (bit for bit JAX's)."""
    def make(m):
        return m.with_master_f32(m.with_schedule(m.adamw,
                                                 m.warmup_cosine(1e-2, 2, 5)))
    for jp, js, tp, ts in _run(make(joptim), make(optim), dtype):
        if dtype == "bfloat16":
            for g, w in zip(tp, jp):
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    g.to(torch.float32).numpy(),
                    np.asarray(w.astype(jnp.float32)))
        else:
            _close(tp, jp)
        _close(_leaves(ts), jax.tree_util.tree_leaves(js))
        assert all(m.dtype == torch.float32 for m in ts.master)


@pytest.mark.parametrize("lr", [None, 1e-2], ids=["relative", "fixed_lr"])
def test_adafactor_matches_jax(lr):
    _check_trajectory(joptim.adafactor(lr), optim.adafactor(lr))
    st = optim.adafactor(lr).init([torch.zeros(s) for s in SHAPES])
    assert [tuple(v.shape) for v in st.vr] == [(16,), (0,), (3, 4)]
    assert [tuple(v.shape) for v in st.vc] == [(32,), (0,), (3, 5)]
    assert [tuple(v.shape) for v in st.v] == [(0,), (32,), (0,)]


def test_adafactor_skips_frozen_parameters():
    opt = optim.adafactor(1e-2)
    params = [torch.ones(4, 4), torch.ones(4)]
    st = opt.init(params)
    st = opt.update([torch.ones(4, 4), None], st, params)
    assert torch.equal(params[1], torch.ones(4)) and not st.v[1].any()
    assert not torch.equal(params[0], torch.ones(4, 4))


def test_adamw_8bit_codes_and_trajectory_match_jax():
    jopt, popt = joptim.adamw_8bit(1e-2), optim.adamw_8bit(1e-2)
    f32 = optim.adamw(1e-2)
    init = _arrays(0, 0.3)
    pf = [torch.from_numpy(a.copy()) for a in init]
    sf = f32.init(pf)
    for t, (jp, js, tp, ts) in enumerate(_run(jopt, popt)):
        sf = f32.update([torch.from_numpy(g) for g in _arrays(100 + t, 0.1)],
                        sf, pf)
        for i, shape in enumerate(SHAPES):
            jm, jv = js.mu[i], js.nu[i]
            tm, tv = ts.mu[i], ts.nu[i]
            assert tm.q.dtype == tv.q.dtype == torch.int8
            assert tuple(tm.q.shape) == shape
            assert tm.scale.numel() == -(-int(np.prod(shape)) // 256)
            np.testing.assert_array_equal(tm.q.numpy(), np.asarray(jm.q))
            np.testing.assert_allclose(tm.scale.numpy(), np.asarray(jm.scale),
                                       rtol=RTOL)
            assert np.abs(tv.q.numpy().astype(int)
                          - np.asarray(jv.q).astype(int)).max() <= 1
            got_v = optim._q8_dequant_log(tv, shape).numpy()
            want_v = np.asarray(joptim._q8_dequant_log(jv, shape))
            # one code step of the log domain: a relative error of
            # exp(scale) - 1 on v (plus the floor)
            step = np.exp(np.asarray(jv.scale).max()) - 1
            assert np.all(np.abs(got_v - want_v)
                          <= step * np.abs(want_v) + 1e-12 + 1e-6 * want_v)
    for i in range(3):
        total = np.abs(pf[i].numpy() - init[i]).max()
        for other in (np.asarray(jp[i]), pf[i].numpy()):
            diff = np.abs(tp[i].numpy() - other).max()
            assert diff < 0.1 * max(total, 1e-6), (i, diff, total)


def test_adamw_8bit_quantizers_match_jax_on_ragged_blocks():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(600) * 1e-3).astype(np.float32)
    v = (rng.random(600) ** 4 * 1e-6).astype(np.float32)
    v[:7] = 0.0
    tm, jm = optim._q8_quant(torch.from_numpy(x)), joptim._q8_quant(
        jnp.asarray(x))
    np.testing.assert_array_equal(tm.q.numpy(), np.asarray(jm.q))
    np.testing.assert_allclose(optim._q8_dequant(tm, x.shape).numpy(),
                               np.asarray(joptim._q8_dequant(jm, x.shape)),
                               rtol=RTOL, atol=0)
    tv, jv = optim._q8_quant_log(torch.from_numpy(v)), joptim._q8_quant_log(
        jnp.asarray(v))
    assert np.abs(tv.q.numpy().astype(int)
                  - np.asarray(jv.q).astype(int)).max() <= 1
    np.testing.assert_allclose(tv.mid.numpy(), np.asarray(jv.mid), rtol=1e-6)
    np.testing.assert_allclose(tv.scale.numpy(), np.asarray(jv.scale),
                               rtol=1e-5)


def _dummy_loss(model, batch):
    x, y = batch
    return cross_entropy(model(x), y), {}


def test_scan_train_steps_equal_single_steps():
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.random((4, 16, 1), dtype=np.float32))
    ys = torch.from_numpy(rng.integers(0, 4, (4, 16)))
    opt = optim.adamw(1e-2)
    ma = DummyModel(1, 8, 4, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    mb = DummyModel(1, 8, 4, device="cpu")
    mb.load_state_dict(ma.state_dict())
    step = make_train_step(_dummy_loss, opt)
    sa = opt.init(ma.parameters())
    want = []
    for t in range(4):
        out = step(ma, sa, (xs[t], ys[t]))
        sa = out.opt_state
        want.append(out.loss)
    run = make_scan_train_steps(_dummy_loss, opt, n_steps=4)
    model, sb, losses = run(mb, opt.init(mb.parameters()), (xs, ys))
    assert model is mb and losses.shape == (4, 1)
    assert torch.equal(losses, torch.stack(want))
    for pa, pb in zip(ma.parameters(), mb.parameters()):
        assert torch.equal(pa, pb)
    assert sb.step == sa.step == 4
