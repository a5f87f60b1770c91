"""The port's checkpoints (``utils/checkpoint.py``, ``ckpt/manager.py``)
against the JAX package's, on the same on-disk format.

- Round trip in the port at float32 and bfloat16: params and the
  ``with_clipping(with_schedule(adamw))`` state come back bit-exact.
- The same values written by both packages give byte-identical
  ``manifest.json``, ``params.npz`` and ``opt_state.npz`` (bfloat16
  leaves as raw bytes in both).
- A JAX-written checkpoint (after one JAX adamw step) restores in the
  port with equal params and optimizer state (exact), and the port's
  next two losses match JAX's (rtol 1e-5: float32, summation order
  only). A port-written one restores through JAX ``restore_checkpoint
  (like_params=, like_opt_state=)`` with equal leaves (exact).
- An exception inside the write leaves the previous step as
  ``latest_step``; retention at ``keep=3``; the async manager commits
  only at the next ``save``/``wait``, and its snapshot holds the values
  of the moment of ``save`` after an in-place update; ``adafactor``'s
  moments (factored ones of a Linear W swapped) map onto JAX's after one
  step of each package (norm-relative 1e-4 per tensor: squared float32
  gradients of two summation orders) and round-trip exactly.
- ``adamw_8bit``: its int8 moments as JAX's ``Q8Moment`` /
  ``Q8LogMoment`` trees; a port round trip is bit-exact and resumes
  exactly; a JAX-written state restores in the port and a port-written
  one in JAX, leaf for leaf, with every dequantized moment equal to the
  writer's (the first bit for bit, the second to float32 ``exp``'s
  ulps: the blocks run over the JAX layout in both, a transposed Linear
  W included) and the next update on the same
  gradients equal to the writer's (rtol 1e-6: float32 rounding of two
  libraries); a state blocked over another order is refused, typed; in
  format 2 the codes shard as their parameters and the scales stay
  whole (the manifest == JAX's).
- World 2 over gloo (``examples/train_transformer_lm.py`` in two CPU
  ranks): the primary writes one checkpoint, both ranks resume from it
  with the same continued losses.

Serial run time ~45 s.
"""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_and_port_lm, launch_cpu_ranks
from distributed_pytorch_tpu import optim as joptim
from distributed_pytorch_tpu.ops.losses import cross_entropy as jax_ce
from distributed_pytorch_tpu.utils import checkpoint as jck
from distributed_pytorch_tpu_torch import optim as toptim
from distributed_pytorch_tpu_torch import to_jax_params
from distributed_pytorch_tpu_torch.ckpt import (CheckpointManager,
                                                CkptIncomplete,
                                                CkptShapeMismatch)
from distributed_pytorch_tpu_torch.examples import train_transformer_lm
from distributed_pytorch_tpu_torch.ops.losses import cross_entropy
from distributed_pytorch_tpu_torch.parallel import make_train_step
from distributed_pytorch_tpu_torch.utils import checkpoint as tck

LR = 1e-2


def _opts():
    """The example's composition, in both packages."""
    j = joptim.with_clipping(joptim.with_schedule(
        joptim.adamw, joptim.warmup_cosine(LR, 1, 6)), 1.0)
    t = toptim.with_clipping(toptim.with_schedule(
        toptim.adamw, toptim.warmup_cosine(LR, 1, 6)), 1.0)
    return j, t


def _batch(seed=0, vocab=61, b=2, s=9):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _port_loss(model, batch):
    x, y = batch
    return cross_entropy(model(torch.as_tensor(x)), torch.as_tensor(y)), {}


def _port_stepped(dtype=torch.float32, seed=0):
    """A port LM and its optimizer state after one step."""
    _, _, pm = jax_and_port_lm(seed=seed, pos="learned")
    pm = pm.to(dtype)
    _, opt = _opts()
    state = opt.init(pm.parameters())
    out = make_train_step(_port_loss, opt)(pm, state, _batch())
    return pm, out.opt_state


def _leaves(tree):
    keys, leaves, _ = tck._flatten(tree)
    return dict(zip(keys, leaves))


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        ta, tb = la[k], lb[k]
        if isinstance(ta, torch.Tensor):
            assert torch.equal(ta, tb), k
        else:
            assert np.array_equal(np.asarray(ta), np.asarray(tb)), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_round_trip(tmp_path, dtype):
    pm, state = _port_stepped(dtype)
    tck.save_checkpoint(str(tmp_path), 3, pm, state, extra={"epoch": 1})
    fresh, _ = _port_stepped(dtype, seed=1)
    _, opt = _opts()
    like = opt.init(fresh.parameters())
    ck = tck.restore_checkpoint(str(tmp_path), like_params=fresh,
                                like_opt_state=like)
    assert ck.step == 3 and ck.extra == {"epoch": 1} and ck.params is fresh
    for p, q in zip(pm.parameters(), fresh.parameters()):
        assert q.dtype == dtype and torch.equal(p, q)
    assert type(ck.opt_state) is type(state)
    assert ck.opt_state.step == state.step == 1
    _assert_states_equal(tck.jax_opt_state(ck.opt_state, fresh),
                         tck.jax_opt_state(state, pm))
    # template-free: nested dicts and lists under the JAX paths
    raw = tck.restore_checkpoint(str(tmp_path))
    assert raw.params["blocks"][0]["attn"]["qkv"]["w"].dtype == dtype
    assert raw.opt_state["inner"]["step"].item() == 1


def test_plain_trees_round_trip(tmp_path):
    """Trees that are no model: nested dicts, lists and NamedTuples of
    tensors and ints, restored template-free and into a template."""
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "layers": [{"b": torch.ones(2, dtype=torch.bfloat16)},
                       {"b": torch.zeros(2, dtype=torch.bfloat16)}],
            "a/b": torch.tensor(3, dtype=torch.int32)}
    state = toptim.ScheduledState(step=np.asarray(4, np.int32),
                                  inner=[torch.full((3,), 2.0)])
    mgr = CheckpointManager(str(tmp_path), keep=1)
    assert mgr.save(0, tree, state, force=True)
    raw = tck.restore_checkpoint(str(tmp_path))
    assert torch.equal(raw.params["layers"][1]["b"], tree["layers"][1]["b"])
    assert torch.equal(raw.params["a/b"], tree["a/b"])
    assert raw.opt_state == {"inner": [raw.opt_state["inner"][0]],
                             "step": raw.opt_state["step"]}
    like = {"w": torch.empty(2, 3), "layers": [{"b": torch.empty(2)}] * 2,
            "a/b": torch.empty(())}
    ck = tck.restore_checkpoint(str(tmp_path), like_params=like,
                                like_opt_state=state)
    assert torch.equal(ck.params["w"], tree["w"])
    assert type(ck.opt_state) is toptim.ScheduledState
    assert int(ck.opt_state.step) == 4
    with pytest.raises(CkptShapeMismatch):
        tck.restore_checkpoint(str(tmp_path), like_params=dict(
            like, w=torch.empty(3, 2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_same_bytes_as_the_jax_package(tmp_path, dtype):
    jm, params, pm = jax_and_port_lm(pos="learned")
    jopt, topt = _opts()
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    pm = pm.to(getattr(torch, dtype))
    jck.save_checkpoint(str(tmp_path / "jax"), 0, params, jopt.init(params))
    tck.save_checkpoint(str(tmp_path / "port"), 0, pm,
                        topt.init(pm.parameters()))
    for name in ("manifest.json", "params.npz", "opt_state.npz"):
        assert filecmp.cmp(tmp_path / "jax" / "step_0" / name,
                           tmp_path / "port" / "step_0" / name,
                           shallow=False), name


def test_sgd_momentum_and_ema_of_an_mlp_as_jax_writes_them(tmp_path):
    """Another model and other optimizer states: the same bytes as the
    JAX package's for the reference's DummyModel under ``with_ema(sgd
    (momentum))``."""
    from distributed_pytorch_tpu import models as jmodels
    from distributed_pytorch_tpu_torch import from_jax_params
    from distributed_pytorch_tpu_torch.models import DummyModel
    params = jax.tree_util.tree_map(np.asarray, jmodels.DummyModel(
        1, 32, 4).init(jax.random.PRNGKey(0)))
    tm = from_jax_params(params, DummyModel(1, 32, 4, device="cpu"))
    jopt = joptim.with_ema(joptim.sgd(0.1, momentum=0.9), 0.9)
    topt = toptim.with_ema(toptim.sgd(0.1, momentum=0.9), 0.9)
    jck.save_checkpoint(str(tmp_path / "jax"), 2, params, jopt.init(params))
    tck.save_checkpoint(str(tmp_path / "port"), 2, tm,
                        topt.init(tm.parameters()))
    for name in ("manifest.json", "params.npz", "opt_state.npz"):
        assert filecmp.cmp(tmp_path / "jax" / "step_2" / name,
                           tmp_path / "port" / "step_2" / name,
                           shallow=False), name


def _jax_loss(jm):
    def loss(p, batch):
        x, y = batch
        return jax_ce(jm.apply(p, jnp.asarray(x)), jnp.asarray(y))
    return loss


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jm, params, pm = jax_and_port_lm(seed=2, pos="learned")
    jopt, topt = _opts()
    loss = _jax_loss(jm)
    state = jopt.init(params)
    grads = jax.grad(loss)(params, _batch(0))
    params, state = jopt.update(grads, state, params)
    jck.save_checkpoint(str(tmp_path), 1, params, state)
    # the JAX continuation: the loss at the restored point, and after
    # one more update
    want = [float(loss(params, _batch(1)))]
    grads = jax.grad(loss)(params, _batch(1))
    params2, _ = jopt.update(grads, state, params)
    want.append(float(loss(params2, _batch(2))))

    like = topt.init(pm.parameters())
    ck = tck.restore_checkpoint(str(tmp_path), like_params=pm,
                                like_opt_state=like)
    got_p = to_jax_params(pm)
    for k, v in _leaves(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_array_equal(_leaves(got_p)[k], v, err_msg=k)
    jl = _leaves(jax.tree_util.tree_map(np.asarray, state))
    for k, v in _leaves(tck.jax_opt_state(ck.opt_state, pm)).items():
        np.testing.assert_array_equal(np.asarray(v), jl[k], err_msg=k)
    step = make_train_step(_port_loss, topt)
    out = step(pm, ck.opt_state, _batch(1))
    got = [out.loss.item(), _port_loss(pm, _batch(2))[0].item()]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jm, params, _ = jax_and_port_lm(seed=3, pos="learned")
    jopt, _ = _opts()
    pm, state = _port_stepped()
    tck.save_checkpoint(str(tmp_path), 7, pm, state)
    like_s = jopt.init(params)
    ck = jck.restore_checkpoint(str(tmp_path), like_params=params,
                                like_opt_state=like_s)
    assert ck.step == 7
    assert (jax.tree_util.tree_structure(ck.opt_state)
            == jax.tree_util.tree_structure(like_s))
    for k, v in _leaves(to_jax_params(pm)).items():
        np.testing.assert_array_equal(
            np.asarray(_leaves(ck.params)[k]), v, err_msg=k)
    want = _leaves(tck.jax_opt_state(state, pm))
    for k, v in _leaves(ck.opt_state).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                      err_msg=k)
    assert int(ck.opt_state.inner.step) == 1


def test_interrupted_save_keeps_the_previous_step(tmp_path, monkeypatch):
    pm, state = _port_stepped()
    tck.save_checkpoint(str(tmp_path), 1, pm, state)
    before = [p.detach().clone() for p in pm.parameters()]

    def torn(path, **arrays):
        with open(path, "wb") as f:
            f.write(b"PK")          # a partial file, then the crash
        raise OSError("disk full")
    monkeypatch.setattr(tck.np, "savez", torn)
    with torch.no_grad():
        for p in pm.parameters():
            p.add_(1.0)
    with pytest.raises(OSError, match="disk full"):
        tck.save_checkpoint(str(tmp_path), 2, pm, state)
    monkeypatch.undo()
    assert tck.latest_step(str(tmp_path)) == 1
    ck = tck.restore_checkpoint(str(tmp_path), like_params=pm)
    assert ck.step == 1
    for p, q in zip(before, pm.parameters()):
        assert torch.equal(p, q)
    # the next save sweeps the torn staging directory
    tck.save_checkpoint(str(tmp_path), 2, pm, state)
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_2"]


def test_retention_keeps_three(tmp_path):
    pm, state = _port_stepped()
    for step in range(6):
        tck.save_checkpoint(str(tmp_path), step, pm, state, keep=3)
    assert tck.available_steps(str(tmp_path)) == [3, 4, 5]
    mgr = CheckpointManager(str(tmp_path / "m"), interval=2, keep=3)
    saved = [s for s in range(12) if mgr.save(s, pm, state)]
    assert saved == [0, 2, 4, 6, 8, 10]
    assert tck.available_steps(str(tmp_path / "m")) == [6, 8, 10]
    assert mgr.save(11, pm, state, force=True)
    assert tck.available_steps(str(tmp_path / "m")) == [8, 10, 11]


def test_async_manager_defers_commit_and_snapshots(tmp_path):
    pm, state = _port_stepped()
    _, opt = _opts()
    d = str(tmp_path)
    mgr = CheckpointManager(d, interval=1, keep=3, async_save=True)
    assert mgr.save(0, pm, state)
    assert tck.latest_step(d) is None          # staged, not committed
    snap = [p.detach().clone() for p in pm.parameters()]
    snap_state = tck.jax_opt_state(state, pm)
    # the next step updates the parameters and moments in place
    state = make_train_step(_port_loss, opt)(pm, state, _batch(5)).opt_state
    assert not all(torch.equal(a, b) for a, b in zip(snap, pm.parameters()))
    mgr.wait()
    assert tck.latest_step(d) == 0
    assert len(mgr.saves) == 1 and mgr.saves[0]["bytes"] > 0
    fresh, _ = _port_stepped(seed=4)
    ck = mgr.restore_latest(like_params=fresh,
                            like_opt_state=opt.init(fresh.parameters()))
    for a, b in zip(snap, fresh.parameters()):
        assert torch.equal(a, b)
    _assert_states_equal(tck.jax_opt_state(ck.opt_state, fresh), snap_state)
    # a second save commits the first only when it is itself staged
    assert mgr.save(1, pm, state)
    assert tck.latest_step(d) == 0
    mgr.wait()
    assert tck.latest_step(d) == 1


def test_adafactor_moments_map_to_the_jax_layout(tmp_path):
    jm, params, pm = jax_and_port_lm(seed=5, pos="learned")
    jopt, topt = joptim.adafactor(), toptim.adafactor()
    jstate = jopt.init(params)
    grads = jax.grad(_jax_loss(jm))(params, _batch(0))
    params, jstate = jopt.update(grads, jstate, params)
    tstate = topt.init(pm.parameters())
    tstate = make_train_step(_port_loss, topt)(pm, tstate, _batch(0)
                                               ).opt_state
    got = _leaves(tck.jax_opt_state(tstate, pm))
    for k, v in _leaves(jax.tree_util.tree_map(np.asarray, jstate)).items():
        # squared float32 gradients of two summation orders, held
        # norm-relative per tensor: an element whose gradient nearly
        # cancels differs by more, relatively (seen 4.7e-4 on 1 of 32)
        a = np.asarray(got[k], np.float64)
        assert a.shape == v.shape, k
        assert np.linalg.norm(a - v) <= 1e-4 * np.linalg.norm(v) + 1e-30, k
    tck.save_checkpoint(str(tmp_path), 1, pm, tstate)
    ck = tck.restore_checkpoint(str(tmp_path), like_params=pm,
                                like_opt_state=topt.init(pm.parameters()))
    for a, b in zip(ck.opt_state.vr + ck.opt_state.vc,
                    tstate.vr + tstate.vc):
        assert torch.equal(a, b)


def test_typed_errors_and_unported_formats(tmp_path):
    pm, state = _port_stepped()
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path))
    tck.save_checkpoint(str(tmp_path), 0, pm, state)
    small, _ = _port_stepped()
    small.blocks = small.blocks[:1]
    with pytest.raises(CkptShapeMismatch):
        tck.restore_checkpoint(str(tmp_path), like_params=small)
    os.remove(tmp_path / "step_0" / "opt_state.npz")
    with pytest.raises(CkptIncomplete):
        tck.restore_checkpoint(str(tmp_path))
    with open(tmp_path / "step_0" / "manifest.json", "w") as f:
        f.write('{"step": 0, "format": 2')
    with pytest.raises(CkptIncomplete):
        tck.restore_checkpoint(str(tmp_path))
    # a format-2 (sharded) manifest goes to the resharding reader, which
    # types one without its mesh as incomplete
    with open(tmp_path / "step_0" / "manifest.json", "w") as f:
        f.write('{"step": 0, "format": 2, "trees": {}}')
    with pytest.raises(CkptIncomplete, match="lacks"):
        tck.restore_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="param_specs"):
        CheckpointManager(str(tmp_path), sharded=True)
    # adamw_8bit's int8 state, once refused, now saves and restores
    q_state = toptim.adamw_8bit(1e-3).init(pm.parameters())
    tck.save_checkpoint(str(tmp_path / "q"), 0, pm, q_state)
    ck = tck.restore_checkpoint(str(tmp_path / "q"), like_params=pm,
                                like_opt_state=q_state)
    _assert_states_equal(ck.opt_state, q_state)


def _q8_stepped(seed=0, steps=1):
    """A port LM and its ``adamw_8bit`` state after ``steps`` steps."""
    _, _, pm = jax_and_port_lm(seed=seed, pos="learned")
    opt = toptim.adamw_8bit(LR)
    state = opt.init(pm.parameters())
    step = make_train_step(_port_loss, opt)
    for i in range(steps):
        state = step(pm, state, _batch(i)).opt_state
    return pm, opt, state


def _is_q8(x):
    return isinstance(x, (joptim.Q8Moment, joptim.Q8LogMoment))


def _port_moments(state, pm):
    """The port ``adamw_8bit`` state's moments dequantized, in the JAX
    layout, keyed ``mu/<param key>`` / ``nu/<param key>``."""
    params = list(pm.parameters())
    out = {}
    for key, s in tck._slots(pm)[1]:
        shape = params[s.index].shape
        out[f"mu/{key}"] = s.to_jax(toptim._q8_dequant(
            state.mu[s.index], shape)).numpy()
        out[f"nu/{key}"] = s.to_jax(toptim._q8_dequant_log(
            state.nu[s.index], shape)).numpy()
    return out


def _jax_moments(state, params):
    """The same of a JAX ``adamw_8bit`` state."""
    out = {}
    for name, deq in (("mu", joptim._q8_dequant),
                      ("nu", joptim._q8_dequant_log)):
        tree = jax.tree_util.tree_map(
            lambda qm, p, f=deq: np.asarray(f(qm, p.shape)),
            getattr(state, name), params, is_leaf=_is_q8)
        out.update({f"{name}/{k}": v for k, v in _leaves(tree).items()})
    return out


def _assert_moments_equal(got, want):
    """The first moments bit for bit; the second to the few ulps of
    float32 ``exp`` in two libraries, and of the 1e-12 floor subtracted
    from it (~1e-19) (its codes and affine maps are equal bit for bit:
    the leaves are compared separately). A code read with another
    block's scale is off by orders of magnitude more."""
    assert got.keys() == want.keys()
    for k in want:
        if k.startswith("mu/"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=3e-7,
                                       atol=1e-18, err_msg=k)


def _port_grads(pm, jgrads):
    """JAX gradients as the port's per-parameter list."""
    leaves = _leaves(jax.tree_util.tree_map(np.asarray, jgrads))
    out = [None] * len(list(pm.parameters()))
    for key, s in tck._slots(pm)[1]:
        out[s.index] = s.from_jax(torch.from_numpy(
            np.array(leaves[key]))).contiguous()
    return out


def _assert_params_close(pm, jparams):
    got = _leaves(to_jax_params(pm))
    for k, v in _leaves(jax.tree_util.tree_map(np.asarray, jparams)).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_adamw_8bit_state_roundtrips_with_exact_resume(tmp_path):
    """JAX's ``test_adamw_8bit_state_roundtrips_with_exact_resume`` on
    the port: codes, scales, midpoints and the step come back bit for
    bit (int8 codes stay int8, each node in JAX's field order), and a
    step from the restored state equals one from the live state."""
    pm, opt, state = _q8_stepped(steps=2)
    tck.save_checkpoint(str(tmp_path), 2, pm, state)
    _, _, pm2 = jax_and_port_lm(seed=9, pos="learned")
    ck = tck.restore_checkpoint(str(tmp_path), like_params=pm2,
                                like_opt_state=opt.init(pm2.parameters()))
    assert ck.opt_state.step == 2
    assert all(m.q.dtype == torch.int8 for m in ck.opt_state.mu)
    _assert_states_equal(ck.opt_state, state)
    tree = tck.jax_opt_state(state, pm)
    assert type(tree.mu["tok"]["emb"])._fields == joptim.Q8Moment._fields
    assert type(tree.nu["tok"]["emb"])._fields == \
        joptim.Q8LogMoment._fields
    step = make_train_step(_port_loss, opt)
    a = step(pm, state, _batch(5))
    b = step(pm2, ck.opt_state, _batch(5))
    assert a.loss.item() == b.loss.item()
    for x, y in zip(pm.parameters(), pm2.parameters()):
        assert torch.equal(x, y)
    _assert_states_equal(b.opt_state, a.opt_state)


def test_adamw_8bit_jax_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint JAX wrote of its ``adamw_8bit`` state restores in the
    port: every code, scale and midpoint equal to JAX's in the JAX
    layout, the step count too; every moment the port dequantizes equals
    JAX's; the next update on JAX's gradients equals JAX's; and the
    port's own resumed step runs."""
    jm, params, pm = jax_and_port_lm(seed=2, pos="learned")
    jopt = joptim.adamw_8bit(LR)
    state = jopt.init(params)
    grads = jax.grad(_jax_loss(jm))(params, _batch(0))
    params, state = jopt.update(grads, state, params)
    jck.save_checkpoint(str(tmp_path), 1, params, state)
    topt = toptim.adamw_8bit(LR)
    ck = tck.restore_checkpoint(str(tmp_path), like_params=pm,
                                like_opt_state=topt.init(pm.parameters()))
    assert ck.opt_state.step == 1
    jl = _leaves(jax.tree_util.tree_map(np.asarray, state))
    got = _leaves(tck.jax_opt_state(ck.opt_state, pm))
    assert got.keys() == jl.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), jl[k], err_msg=k)
    _assert_moments_equal(_port_moments(ck.opt_state, pm),
                          _jax_moments(state, params))
    grads = jax.grad(_jax_loss(jm))(params, _batch(1))
    params2, state2 = jopt.update(grads, state, params)
    state_p = topt.update(_port_grads(pm, grads), ck.opt_state,
                          list(pm.parameters()))
    _assert_params_close(pm, params2)
    assert state_p.step == int(state2.step) == 2
    out = make_train_step(_port_loss, topt)(pm, state_p, _batch(2))
    assert np.isfinite(out.loss.item()) and out.opt_state.step == 3


def test_adamw_8bit_port_checkpoint_restores_in_jax(tmp_path):
    """The port's ``adamw_8bit`` checkpoint restores through JAX
    ``restore_checkpoint(like_params=, like_opt_state=)`` into JAX's own
    state structure, every leaf equal to the port's in the JAX layout
    (int8 codes, float32 scales and midpoints, the int32 step); every
    moment JAX dequantizes equals the port's, and JAX's next update on
    the same gradients equals the port's."""
    jm, params, _ = jax_and_port_lm(seed=3, pos="learned")
    pm, topt, state = _q8_stepped(steps=1)
    tck.save_checkpoint(str(tmp_path), 4, pm, state)
    like_s = joptim.adamw_8bit(LR).init(params)
    ck = jck.restore_checkpoint(str(tmp_path), like_params=params,
                                like_opt_state=like_s)
    assert ck.step == 4
    assert (jax.tree_util.tree_structure(ck.opt_state)
            == jax.tree_util.tree_structure(like_s))
    assert int(ck.opt_state.step) == 1
    want = _leaves(tck.jax_opt_state(state, pm))
    for k, v in _leaves(ck.opt_state).items():
        assert np.asarray(v).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                      err_msg=k)
    jparams = jax.tree_util.tree_map(jnp.asarray, ck.params)
    _assert_moments_equal(_jax_moments(ck.opt_state, jparams),
                          _port_moments(state, pm))
    grads = jax.grad(_jax_loss(jm))(jparams, _batch(1))
    params2, _ = joptim.adamw_8bit(LR).update(grads, ck.opt_state, jparams)
    topt.update(_port_grads(pm, grads), state, list(pm.parameters()))
    _assert_params_close(pm, params2)


def test_adamw_8bit_state_blocked_in_another_order_is_refused(tmp_path):
    """A parameter that lost its layout mark before ``optimizer.init``
    (a Linear W made anew without ``optim.mark_jax_perm``) has its
    moments blocked over the port's (out, in) order, whose codes the
    JAX layout would read with other blocks' scales: saving that state,
    and restoring a file into it, raise ``CkptError``."""
    from distributed_pytorch_tpu_torch.ckpt import CkptError
    pm, opt, state = _q8_stepped(steps=1)
    tck.save_checkpoint(str(tmp_path), 1, pm, state)
    w = pm.blocks[0].attn.qkv.weight
    delattr(w, toptim.JAX_PERM)
    unmarked = opt.init(pm.parameters())
    with pytest.raises(CkptError, match="qkv"):
        tck.save_checkpoint(str(tmp_path / "x"), 1, pm, unmarked)
    with pytest.raises(CkptError, match="JAX layout"):
        tck.restore_checkpoint(str(tmp_path), like_params=pm,
                               like_opt_state=unmarked)


def test_adamw_8bit_format2_manifest_equals_jax_and_round_trips(tmp_path):
    """Format 2 (dp 4, one writer): the codes shard as their parameters
    and the scales and midpoints stay whole, so the manifest of a fresh
    ``adamw_8bit`` state equals the one JAX's manager writes for its own
    (specs derived by the manager, and ``shard_layouts``' per-parameter
    specs); a stepped state restores bit for bit."""
    from distributed_pytorch_tpu.ckpt import CheckpointManager as JManager
    from distributed_pytorch_tpu.parallel import fsdp as jfsdp
    from distributed_pytorch_tpu_torch.parallel import fsdp
    jm, params, pm = jax_and_port_lm(seed=0, pos="learned")
    with JManager(str(tmp_path / "j"), sharded=True,
                  param_specs=jfsdp.fsdp_param_specs(params, 4),
                  axis_sizes={"dp": 4}) as mgr:
        mgr.save(1, params, joptim.adamw_8bit(LR).init(params))
    want = json.load(open(tmp_path / "j" / "step_1" / "manifest.json"))
    opt = toptim.adamw_8bit(LR)
    fresh = opt.init(pm.parameters())
    p_specs, o_specs, axes = fsdp.shard_layouts(pm, fresh, n_shards=4)
    for name, kw in (("derived", {}), ("layouts", dict(opt_specs=o_specs))):
        with CheckpointManager(str(tmp_path / name), sharded=True,
                               param_specs=p_specs, axis_sizes=axes,
                               **kw) as mgr:
            mgr.save(1, pm, fresh)
        assert json.load(open(tmp_path / name / "step_1" /
                              "manifest.json")) == want, name
    stepped = make_train_step(_port_loss, opt)(pm, fresh, _batch()).opt_state
    with CheckpointManager(str(tmp_path / "s"), sharded=True,
                           param_specs=p_specs, axis_sizes=axes) as mgr:
        mgr.save(2, pm, stepped)
    ck = tck.restore_checkpoint(str(tmp_path / "s"), like_params=pm,
                                like_opt_state=opt.init(pm.parameters()))
    assert ck.step == 2
    _assert_states_equal(ck.opt_state, stepped)


LM = ["--device", "cpu", "--batch-size", "2", "--seq-len", "16", "--dim",
      "16", "--n-layers", "1", "--n-heads", "2", "--data-size", "32",
      "--log-every", "1"]


def test_world2_primary_writes_every_rank_reads(tmp_path):
    ck = str(tmp_path / "ck")
    full, part = tmp_path / "full", tmp_path / "part"
    full.mkdir()
    part.mkdir()
    launch_cpu_ranks(train_transformer_lm.main_worker, 2,
                     LM + ["--steps", "6"], True, None, str(full))
    launch_cpu_ranks(train_transformer_lm.main_worker, 2,
                     LM + ["--steps", "4", "--save", ck, "--save-every",
                           "3"], True, None, str(part))
    # one checkpoint per step, written once (no per-rank copies)
    assert sorted(os.listdir(ck)) == ["step_0", "step_3"]
    assert sorted(os.listdir(os.path.join(ck, "step_3"))) == [
        "manifest.json", "opt_state.npz", "params.npz"]
    launch_cpu_ranks(train_transformer_lm.main_worker, 2,
                     LM + ["--steps", "6", "--save", ck, "--resume"],
                     True, None, str(part))
    want = torch.load(full / "rank0.pt", weights_only=False)["losses"]
    for r in range(2):
        rec = torch.load(part / f"rank{r}.pt", weights_only=False)
        assert rec["start_step"] == 4
        assert rec["losses"] == want[4:]
