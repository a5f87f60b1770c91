"""Training through the helper API: the port against the JAX package.

- ``min_ddp``: the port's example against the JAX ``examples/min_ddp.py``
  (driven as ``tests/test_data_parallel.py`` drives it) from the same
  weights (the JAX ``DummyModel`` of ``PRNGKey(0)``, converted). World
  1: the 8 reduced losses agree to rtol 1e-5 (float32, summation order
  only). World 2 over gloo at per-rank batch 4: the reduced loss (a SUM)
  over 2 equals the JAX unshuffled world-1 run at batch 8 to rtol 2e-4,
  atol 1e-5, that test's own limits.
- ``make_train_step`` at world 2 over gloo (``examples/ddp_lm.py``, 3
  adamw steps of a 2-layer, dim-32 LM): both ranks bit-identical; equal
  to the port's world-1 step at the doubled batch and to the JAX
  world-1 ``make_train_step`` on the same global batches, rtol 1e-5 on
  every parameter after every step (float32). Elements near zero get
  an absolute floor: 1e-7 against the port's own world-1 step, and
  1e-6 = 1e-3 lr against JAX, whose other summation order can move an
  element whose gradient nearly cancels a fraction of an Adam step
  (seen: 3.0e-7 on one of 1952 elements).
- ``mixed_precision="bf16"``: the port's step against the JAX step on
  the same LM and batch: loss within 1e-2 relative, float32 gradients
  and masters, each master tensor within 1e-2 (norm-relative) after one
  step. bf16 rounds the forward and backward differently on each side,
  so this is the dtype's tolerance, not float32's. The masters' change
  in that step agrees with JAX's within 0.25 (norm-relative), and the
  port's bf16 gradient sits within 3e-2 of JAX's bf16 gradient and
  between 1/3 and 3 times as far from its float32 gradient as JAX's is
  from its own: a step computed in float32 fails that.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_pytorch_tpu as jdist
from _torch_port import CPU, launch_cpu_ranks, small_lm_kwargs
from distributed_pytorch_tpu import data as jdata
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu import optim as joptim
from distributed_pytorch_tpu.ops.losses import cross_entropy as jax_ce
from distributed_pytorch_tpu.parallel import \
    make_train_step as jax_make_train_step
from distributed_pytorch_tpu.parallel import \
    mp_cast_params as jax_mp_cast_params
from distributed_pytorch_tpu_torch import TransformerLM, from_jax_params
from distributed_pytorch_tpu_torch.examples import ddp_lm, min_ddp
from distributed_pytorch_tpu_torch.models import DummyModel
from distributed_pytorch_tpu_torch.ops.losses import cross_entropy
from distributed_pytorch_tpu_torch.optim import adamw, sgd
from distributed_pytorch_tpu_torch.parallel import (make_train_step,
                                                    mp_cast_params)

jex = importlib.import_module("examples.min_ddp")


def _jax_dummy_state():
    """The JAX example's initial weights as a port state dict."""
    jm = jmodels.DummyModel(in_dim=1, hidden_dim=32, n_classes=4)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    tm = from_jax_params(params, DummyModel(1, 32, 4, device="cpu"))
    return {k: v.numpy().copy() for k, v in tm.state_dict().items()}


def _jax_history(monkeypatch, shuffle):
    monkeypatch.setenv("DPX_CPU_DEVICES", "1")
    if not shuffle:
        orig = jex.DataLoader

        def no_shuffle_loader(*a, **kw):
            kw["shuffle"] = False
            return orig(*a, **kw)
        monkeypatch.setattr(jex, "DataLoader", no_shuffle_loader)
    hist = []
    jex.main_worker(0, 1, argv=["--epochs", "2", "--batch-size", "8"],
                    quiet=True, history=hist)
    return hist


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def test_min_ddp_world1_matches_jax(monkeypatch, tmp_path):
    want = _jax_history(monkeypatch, shuffle=True)
    path = str(tmp_path / "hist.json")
    min_ddp.main_worker(0, 1, ["--device", "cpu"], quiet=True,
                        history_path=path, init_state=_jax_dummy_state())
    got = _read_json(path)
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_min_ddp_world2_gloo_matches_jax_unshuffled(monkeypatch, tmp_path):
    want = _jax_history(monkeypatch, shuffle=False)
    path = str(tmp_path / "hist.json")
    launch_cpu_ranks(min_ddp.main_worker, 2,
                     ["--device", "cpu", "--batch-size", "4"], True, path,
                     _jax_dummy_state())
    got = [v / 2 for v in _read_json(path)]
    assert len(got) == 8
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_min_ddp_prints_the_reference_lines(capsys):
    min_ddp.main_worker(0, 0, ["--epochs", "1"])
    out = capsys.readouterr().out
    assert "epochs      : 1" in out and "Run epochs" in out
    assert out.count("Device: cpu") == 4
    assert "Finish iteration 3 - acc: " in out and " - loss: " in out


# -- make_train_step at world 2 -------------------------------------------

LM = small_lm_kwargs(max_seq=32)
SEQ, DATA, STEPS, LR = 12, 16, 3, 1e-3


def _lm_cfg(init_state, batch_size):
    return ddp_lm.Config(model=LM, seq_len=SEQ, batch_size=batch_size,
                         data_size=DATA, steps=STEPS, warmup=0, lr=LR,
                         dtype="float32", device="cpu",
                         init_state=init_state, record_params=True)


def _jax_lm(seed):
    jm = jmodels.TransformerLM(**LM)
    params = jm.init(jax.random.PRNGKey(seed))
    return jm, params


def _port_state(params):
    pm = TransformerLM(device=CPU, **LM)
    from_jax_params(jax.tree_util.tree_map(np.asarray, params), pm)
    return {k: v.detach().numpy().copy() for k, v in pm.state_dict().items()}


def _jax_trajectory(jm, params, batch_size):
    """JAX world-1 make_train_step over the same global batches: the
    port's world-1 loader (shuffle, seed 0) is the JAX loader's."""
    opt = joptim.adamw(LR)
    jparams = jdist.replicate(params)
    jstate = jdist.replicate(opt.init(jparams))

    def loss_fn(p, batch):
        x, y = batch
        return jax_ce(jm.apply(p, x).astype(jnp.float32), y), {}

    step = jax_make_train_step(loss_fn, opt)
    loader = jdata.DataLoader(jdata.SyntheticLM(DATA, SEQ, LM["vocab"]),
                              batch_size, shuffle=True)
    out = []
    for (x, y), _ in zip(loader, range(STEPS)):
        jparams, jstate, _, _ = step(jparams, jstate,
                                     jdist.shard_batch((x, y)))
        out.append(_port_state(jparams))
    return out


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    jm, params = _jax_lm(seed=21)
    state = _port_state(params)
    out = tmp_path_factory.mktemp("ddp_lm_w2")
    launch_cpu_ranks(ddp_lm.main_worker, 2, _lm_cfg(state, 2), str(out))
    w2 = [torch.load(out / f"rank{r}.pt", weights_only=False)
          for r in range(2)]
    w1 = ddp_lm.main_worker(0, 1, _lm_cfg(state, 4))
    return {"w2": w2, "w1": w1, "jax": _jax_trajectory(jm, params, 4)}


def _assert_params_close(got, want, atol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=atol,
                                   err_msg=k)


def test_world2_ranks_hold_bit_identical_params(lm_runs):
    r0, r1 = lm_runs["w2"]
    assert (r0["world_size"], r1["world_size"]) == (2, 2)
    assert len(r0["params"]) == len(r1["params"]) == STEPS
    for a, b in zip(r0["params"], r1["params"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_world2_equals_world1_at_the_doubled_batch(lm_runs):
    for got, want in zip(lm_runs["w2"][0]["params"],
                         lm_runs["w1"]["params"]):
        _assert_params_close(got, want, atol=1e-7)
    # the reduced loss is the SUM of the ranks' local means
    np.testing.assert_allclose(np.asarray(lm_runs["w2"][0]["reduced"]) / 2,
                               lm_runs["w1"]["losses"], rtol=1e-5)


def test_world2_equals_jax_world1(lm_runs):
    assert len(lm_runs["jax"]) == STEPS
    for got, want in zip(lm_runs["w2"][0]["params"], lm_runs["jax"]):
        _assert_params_close(got, want, atol=1e-3 * LR)


def test_world2_gathers_every_example_on_rank0(lm_runs):
    r0, r1 = lm_runs["w2"]
    for g0, g1, w1 in zip(r0["gathered"], r1["gathered"],
                          lm_runs["w1"]["gathered"]):
        assert len(g0) == 4 and g1 == [0.0] * 4
        np.testing.assert_allclose(sorted(g0), sorted(w1), rtol=1e-5)


# -- the bf16 policy ------------------------------------------------------

def _flat(state):
    return np.concatenate([np.ravel(state[k]) for k in sorted(state)])


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bf16_policy_matches_jax():
    jm, params = _jax_lm(seed=23)
    params = jax.tree_util.tree_map(np.asarray, params)
    init = _port_state(params)
    tokens = np.random.default_rng(24).integers(0, LM["vocab"], (4, 13))

    def jloss(p, batch):
        return jax_ce(jm.apply(p, batch[:, :-1]).astype(jnp.float32),
                      batch[:, 1:]), {}

    jopt = joptim.adamw(LR)
    fresh = jax.tree_util.tree_map(jnp.asarray, params)
    jstep = jax_make_train_step(jloss, jopt, mixed_precision="bf16")
    jparams, _, jl, _ = jstep(jdist.replicate(fresh),
                              jdist.replicate(jopt.init(fresh)),
                              jdist.shard_batch(jnp.asarray(tokens)))
    jgrads = {policy: _flat(_port_state(jax.grad(
        lambda p: jloss(cast(p), tokens)[0])(params)))
        for policy, cast in (("bf16", jax_mp_cast_params),
                             ("off", lambda p: p))}

    def tloss(model, batch):
        return cross_entropy(model(batch[:, :-1]), batch[:, 1:]), {}

    tgrads = {}
    for policy in ("off", "bf16"):
        pm = TransformerLM(device=CPU, **LM)
        from_jax_params(params, pm)
        topt = adamw(LR)
        out = make_train_step(tloss, topt, mixed_precision=policy)(
            pm, topt.init(pm.parameters()), torch.from_numpy(tokens))
        tgrads[policy] = _flat({k: p.grad.numpy()
                                for k, p in pm.named_parameters()})
    np.testing.assert_allclose(out.loss.numpy(), np.asarray(jl), rtol=1e-2)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in pm.parameters())
    want = _port_state(jparams)
    got = {k: v.numpy() for k, v in pm.state_dict().items()}
    for k in got:
        err = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert err <= 1e-2, (k, err)
    # the step moved the masters as JAX's did (a master left unchanged
    # reads 1.0): Adam's first step is about +-lr per element, and an
    # element whose gradient nearly cancels takes either sign under
    # either side's bf16 rounding (seen: 0.12-0.14 over four seeds)
    moved = _rel(_flat(got) - _flat(init), _flat(want) - _flat(init))
    assert moved <= 0.25, moved
    # the gradients are bf16's, not float32's: the port's bf16 gradient
    # lies as far from its float32 one as JAX's does from JAX's (seen:
    # 0.74-0.88 times; float32 compute reads 0), and within bf16's
    # noise of JAX's bf16 gradient (seen: 0.009-0.012)
    gap = _rel(tgrads["bf16"], tgrads["off"]) / _rel(jgrads["bf16"],
                                                     jgrads["off"])
    assert 1 / 3 <= gap <= 3, gap
    assert _rel(tgrads["bf16"], jgrads["bf16"]) <= 3e-2


def test_bf16_step_differs_from_f32_and_env_selects_it(monkeypatch):
    """The policy really computes in bf16 (the loss moves off the f32
    one), ``DPX_MP_POLICY`` selects it when the argument is None, and an
    unknown policy raises."""
    tokens = torch.from_numpy(
        np.random.default_rng(25).integers(0, LM["vocab"], (2, 9)))

    def tloss(model, batch):
        return cross_entropy(model(batch[:, :-1]), batch[:, 1:]), {}

    losses = {}
    for policy in ("off", "bf16", None):
        torch.manual_seed(0)
        pm = TransformerLM(device=CPU, **LM)
        monkeypatch.setenv("DPX_MP_POLICY", "bf16")
        opt = adamw(LR)
        losses[policy] = make_train_step(tloss, opt, mixed_precision=policy)(
            pm, opt.init(pm.parameters()), tokens).loss.item()
    assert losses["bf16"] == losses[None] != losses["off"]
    with pytest.raises(ValueError):
        make_train_step(tloss, adamw(LR), mixed_precision="fp8")


def test_mp_cast_params_casts_float32_only_and_restores():
    pm = TransformerLM(device=CPU, tie_embeddings=True, pos="none",
                       **{k: v for k, v in LM.items() if k != "pos"})
    pm.ln_f.scale.data = pm.ln_f.scale.data.to(torch.bfloat16)
    before = dict(pm.named_parameters())
    with mp_cast_params(pm) as m:
        assert m is pm
        assert pm.tok.weight.dtype == torch.bfloat16
        assert pm.head_weight() is pm.tok.weight       # tied: one cast
        assert pm.ln_f.scale is before["ln_f.scale"]   # already bf16
        assert not isinstance(pm.tok.weight, torch.nn.Parameter)
    assert dict(pm.named_parameters()) == before
    assert all(isinstance(p, torch.nn.Parameter) for p in pm.parameters())


@pytest.mark.parametrize("make_opt", [lambda: adamw(LR),
                                      lambda: sgd(LR, momentum=0.9)],
                         ids=["adamw", "sgd_momentum"])
def test_world1_step_leaves_frozen_params_and_buffers_alone(make_opt):
    """requires_grad=False parameters get no gradient, and the optimizer
    (adamw at its default weight decay, sgd with momentum) leaves them
    and their state alone over two steps; the step still updates every
    trainable parameter."""
    pm = TransformerLM(device=CPU, **LM)
    pm.ln_f.scale.requires_grad_(False)       # ones: decay would move it
    frozen = pm.ln_f.scale.detach().clone()
    opt = make_opt()
    tokens = torch.from_numpy(
        np.random.default_rng(26).integers(0, LM["vocab"], (2, 9)))
    before = {k: v.detach().clone() for k, v in pm.named_parameters()}

    def tloss(model, batch):
        return cross_entropy(model(batch[:, :-1]), batch[:, 1:]), {}

    step, state = make_train_step(tloss, opt), opt.init(pm.parameters())
    for _ in range(2):
        state = step(pm, state, tokens).opt_state
    assert pm.ln_f.scale.grad is None
    assert torch.equal(pm.ln_f.scale, frozen)
    i = [p is pm.ln_f.scale for p in pm.parameters()].index(True)
    for moments in (state.mu, state.nu) if hasattr(state, "mu") else (state,):
        assert not moments[i].any()
    moved = [k for k, v in pm.named_parameters()
             if not torch.equal(v, before[k])]
    assert len(moved) == len(before) - 1


def test_config_is_a_dataclass_of_the_flagship():
    cfg = ddp_lm.Config()
    assert dataclasses.asdict(cfg)["model"] == ddp_lm.FLAGSHIP
    assert (cfg.batch_size, cfg.seq_len, cfg.lr) == (8, 1024, 3e-4)
