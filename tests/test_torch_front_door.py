"""The port's front door (``parallel/front_door.py``) against the JAX
package's.

- The builder cache: an identical request returns the same step with its
  build counts unchanged; each keyed kwarg (``donate``, ``wire``,
  ``mixed_precision``, ``specs``, ``remat``, ``weight_update``,
  ``pad_multiple``) is a different point; ``DPX_DONATE`` is the default
  of ``donate``; every shim (``make_train_step``,
  ``make_fsdp_train_step``, ``make_zero1/2_train_step``,
  ``make_spmd_train_step``, ``make_spmd_sharded_train_step``) returns
  the front door's step. The JAX package's ``ValueError`` for each bad
  argument, message for message.
- The spec matrix at world 1 against JAX's ``make_step`` on the same
  weights and batch (the MLP of the JAX suite, ``adamw(1e-3,
  eps=1e-6)``, 5 steps): every dp point and the sharded update, losses
  rtol 1e-5 atol 1e-6 (``test_torch_fsdp.py``'s tolerance); one build
  per point. ``state_specs`` of the sharded update equals JAX's tree and
  feeds the sharded checkpoint, which restores it bit for bit and which
  JAX reads with its own sharded state's keys and shapes.
- Two gloo ranks (``_torch_front_door_workers.matrix_worker``): every dp
  point, ZeRO-3/2/1 and ``FROM_INPUTS`` against the replicated oracle
  (the port's world-1 step on the whole batch; the exact points at rtol
  1e-5 atol 1e-6, the quantized wires at the JAX suite's bounds), one
  build per point (per width under ``adaptive``), out == in shardings
  for every engine; the flash path of a TransformerLM on DTensors, and
  the same batch sharded along the sequence (two steps: JAX's loss,
  then the plain step's after one update); the train ->
  eval -> serve-admit chain with zero ``redistribute`` / ``full_tensor``
  calls, a mis-placed model refused by the engine, ``generate`` and the
  eval; the ZeRO-3 eval pinned to the step's tree of shardings. These
  are the port's own world-2 numbers, not JAX's mesh-8 ones (ROADMAP.md
  "Reference caveats").
- The host door at world 2: ``make_step`` dispatches to the host engines
  (uncached, no sharding contract).

Serial run time ~40 s (two launches of two ranks).
"""

import os

import jax
import numpy as np
import pytest
import torch

import _torch_front_door_workers as fw
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu import optim as joptim
from distributed_pytorch_tpu.ops.losses import cross_entropy as jax_ce
from distributed_pytorch_tpu.parallel import front_door as jfd
from distributed_pytorch_tpu_torch.optim.sharded import \
    make_spmd_sharded_train_step
from distributed_pytorch_tpu_torch.parallel import (FROM_INPUTS,
                                                    FrontDoorStep,
                                                    StepSpecs, front_door,
                                                    fsdp, make_step,
                                                    make_spmd_train_step,
                                                    make_train_step)
from distributed_pytorch_tpu_torch.parallel.tensor import P

WORLD = 2
EXACT = dict(rtol=1e-5, atol=1e-6)
#: the JAX suite's bounds for the quantized wires against the oracle
QUANT_RTOL = {"quant-replicated": 5e-2, "q4-replicated": 2e-1,
              "adaptive-replicated": 5e-2, "quant-sharded": 5e-2}


@pytest.fixture(autouse=True)
def _fresh_cache():
    front_door.cache_clear()
    jfd.cache_clear()
    yield
    front_door.cache_clear()
    jfd.cache_clear()


def _jax_mlp(seed=0):
    jm = jmodels.DummyModel(**fw.MLP)
    params = jm.init(jax.random.PRNGKey(seed))
    return jm, params, jax.tree_util.tree_map(np.asarray, params)


def _batch(n=16):
    rng = np.random.default_rng(3)
    return (rng.random((n, fw.MLP["in_dim"])).astype(np.float32),
            (np.arange(n) % 4).astype(np.int64))


def _lm_data():
    jm = jmodels.TransformerLM(**fw.LM)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    return params, rng.integers(0, fw.LM["vocab"], (8, 17)).astype(np.int64)


def _port_run(step, model, state, batch, steps=fw.STEPS):
    losses = []
    for _ in range(steps):
        out = step(model, state, batch)
        state = out.opt_state
        losses.append(float(out.loss.float().mean()))
    return losses, state


def _oracle(params_np, batch):
    """The replicated step at world 1 on the whole batch."""
    model = fw.mlp(params_np)
    opt = fw.adamw()
    step = make_step(fw.mlp_loss, opt, donate=False)
    return _port_run(step, model, opt.init(model.parameters()),
                     tuple(torch.from_numpy(a) for a in batch))[0]


# -- the builder cache ------------------------------------------------------

def test_same_request_returns_the_cached_step_built_once():
    _, _, p_np = _jax_mlp()
    model, opt = fw.mlp(p_np), fw.adamw()
    a = make_step(fw.mlp_loss, opt)
    b = make_step(fw.mlp_loss, opt)
    assert a is b and isinstance(a, FrontDoorStep)
    batch = tuple(torch.from_numpy(x) for x in _batch())
    out = a(model, opt.init(model.parameters()), batch)
    b(model, out.opt_state, batch)
    assert a.compiles == 1 and a.trace_counts == {8: 1}
    assert make_train_step(fw.mlp_loss, opt) is a
    assert a.in_shardings is None and a.out_shardings is None  # world 1


@pytest.mark.parametrize("kw", [
    dict(donate=False), dict(wire="quant"), dict(mixed_precision="bf16"),
    dict(specs=FROM_INPUTS), dict(remat="full"),
    dict(weight_update="sharded"), dict(weight_update="sharded",
                                        pad_multiple=2048)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_each_keyed_kwarg_is_its_own_point(kw):
    opt = fw.adamw()
    base = make_step(fw.mlp_loss, opt, donate=True)
    other = make_step(fw.mlp_loss, opt, **dict(dict(donate=True), **kw))
    assert other is not base
    assert make_step(fw.mlp_loss, opt, **dict(dict(donate=True), **kw)) \
        is other
    assert other.donated == kw.get("donate", True)
    assert make_step(fw.mlp_loss, opt, donate=True) is base


def test_dpx_donate_is_the_default(monkeypatch):
    opt = fw.adamw()
    monkeypatch.setenv("DPX_DONATE", "0")
    off = make_step(fw.mlp_loss, opt)
    assert not off.donated
    monkeypatch.delenv("DPX_DONATE")
    on = make_step(fw.mlp_loss, opt)
    assert on.donated and on is not off


def test_memory_analysis_counts_and_types_what_it_cannot_measure():
    _, _, p_np = _jax_mlp()
    model, opt = fw.mlp(p_np), fw.adamw()
    step = make_step(fw.mlp_loss, opt)
    state = opt.init(model.parameters())
    batch = tuple(torch.from_numpy(x) for x in _batch())
    ma = step.memory_analysis(model, state, batch)
    n_params = sum(p.numel() for p in model.parameters())
    assert ma["alias"] == 3 * 4 * n_params          # params + mu + nu
    assert ma["argument"] == ma["alias"] + sum(
        t.numel() * t.element_size() for t in batch)
    assert ma["output"] == ma["alias"] + 4
    for key in ("temp", "peak_bytes"):
        with pytest.raises(front_door.MemoryAnalysisUnavailable,
                           match="compiled program"):
            ma[key]


def test_shims_build_through_the_front_door():
    _, _, p_np = _jax_mlp()
    opt = fw.adamw()
    assert isinstance(make_train_step(fw.mlp_loss, opt), FrontDoorStep)
    spmd = make_spmd_train_step(fw.mlp_loss, opt)
    assert spmd is make_step(fw.mlp_loss, opt, specs=FROM_INPUTS)
    sh = make_spmd_sharded_train_step(fw.mlp_loss, opt)
    assert sh is make_step(fw.mlp_loss, opt, weight_update="sharded")
    assert hasattr(sh, "state_specs") and hasattr(sh, "init_opt_state")
    mesh = front_door.context.get_mesh()
    model = fw.mlp(p_np)
    z3 = fsdp.make_fsdp_train_step(fw.mlp_loss, opt, mesh,
                                   fsdp.fsdp_param_specs(model, 1))
    assert isinstance(z3, FrontDoorStep)
    assert z3.config[5] == repr(StepSpecs(fsdp.fsdp_param_specs(model, 1)))
    for build in (fsdp.make_zero1_train_step, fsdp.make_zero2_train_step):
        step, specs = build(fw.mlp_loss, opt, mesh, model)
        assert isinstance(step, FrontDoorStep)


@pytest.mark.parametrize("kw", [
    dict(wire="int16"), dict(mixed_precision="fp8"),
    dict(weight_update="tp"), dict(weight_update="sharded", wire="q4"),
    dict(weight_update="sharded", wire="adaptive")],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_value_errors_equal_jax(kw):
    jm, params, _ = _jax_mlp()

    def jloss(p, b):
        return jax_ce(jm.apply(p, b[0]), b[1]), {}
    with pytest.raises(ValueError) as want:
        jfd.make_step(jloss, joptim.adamw(1e-3), **kw)
    with pytest.raises(ValueError) as got:
        make_step(fw.mlp_loss, fw.adamw(), **kw)
    assert str(got.value) == str(want.value)


# -- the spec matrix at world 1 against JAX ---------------------------------

def _jax_point(wire, wu, batch, steps=fw.STEPS):
    jm, params, _ = _jax_mlp()
    opt = joptim.adamw(fw.LR, eps=fw.EPS)

    def jloss(p, b):
        return jax_ce(jm.apply(p, b[0]), b[1]), {}
    step = jfd.make_step(jloss, opt, wire=wire, weight_update=wu,
                         donate=False)
    state = (step.init_opt_state(params) if wu == "sharded"
             else opt.init(params))
    jb = (batch[0], batch[1].astype(np.int32))
    losses = []
    for _ in range(steps):
        out = step(params, state, jb)
        params, state = out.params, out.opt_state
        losses.append(float(np.asarray(out.loss).mean()))
    return losses


@pytest.mark.parametrize("name,wire,wu", fw.DP_POINTS,
                         ids=[p[0] for p in fw.DP_POINTS])
def test_world1_point_equals_jax(name, wire, wu):
    _, _, p_np = _jax_mlp()
    batch = _batch()
    model, opt = fw.mlp(p_np), fw.adamw()
    step = make_step(fw.mlp_loss, opt, wire=wire, weight_update=wu,
                     donate=False)
    state = (step.init_opt_state(model) if wu == "sharded"
             else opt.init(model.parameters()))
    got, _ = _port_run(step, model, state,
                       tuple(torch.from_numpy(a) for a in batch))
    np.testing.assert_allclose(got, _jax_point(wire, wu, batch), **EXACT)
    assert step.compiles == 1, step.trace_counts


def test_sharded_state_specs_feed_the_sharded_checkpoint(tmp_path):
    from distributed_pytorch_tpu.utils import checkpoint as jck
    from distributed_pytorch_tpu_torch.ckpt import CheckpointManager
    from distributed_pytorch_tpu_torch.utils import checkpoint as tck

    _, _, p_np = _jax_mlp()
    model, opt = fw.mlp(p_np), fw.adamw()
    step = make_step(fw.mlp_loss, opt, weight_update="sharded",
                     donate=False)
    state = step.init_opt_state(model)
    batch = tuple(torch.from_numpy(a) for a in _batch())
    state = step(model, state, batch).opt_state
    specs = step.state_specs(state)
    assert specs.master == P("dp") and specs.inner.mu == P("dp")
    assert specs.inner.step == P()
    # JAX's own tree for the same point
    jm, params, _ = _jax_mlp()
    jstep = jfd.make_step(lambda p, b: (jax_ce(jm.apply(p, b[0]), b[1]),
                                        {}),
                          joptim.adamw(fw.LR, eps=fw.EPS),
                          weight_update="sharded", donate=False)
    jstate = jstep.init_opt_state(params)
    jspecs = jstep.state_specs(jstate)
    assert (tuple(specs.master), tuple(specs.inner.mu),
            tuple(specs.inner.nu), tuple(specs.inner.step)) == (
        tuple(jspecs.master), tuple(jspecs.inner.mu),
        tuple(jspecs.inner.nu), tuple(jspecs.inner.step))
    ck = str(tmp_path / "ck")
    with CheckpointManager(ck, sharded=True, param_specs=fsdp
                           .fsdp_param_specs(model, 2),
                           opt_specs=specs, axis_sizes={"dp": 2}) as mgr:
        mgr.save(1, model, state)
    fresh = fw.mlp(_jax_mlp(seed=1)[2])
    like = step.init_opt_state(fresh)
    got = tck.restore_checkpoint(ck, like_params=fresh, like_opt_state=like)
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    assert got.opt_state.inner.step == state.inner.step == 1
    for a, b in ((got.opt_state.master, state.master),
                 (got.opt_state.inner.mu[0], state.inner.mu[0]),
                 (got.opt_state.inner.nu[0], state.inner.nu[0])):
        assert torch.equal(a, b)
    # JAX reads the port's file with its own sharded state's keys
    jck_state = jck.restore_checkpoint(ck).opt_state
    want = {"inner": {"mu": None, "nu": None, "step": None},
            "master": None}
    assert set(jck_state) == set(want)
    assert set(jck_state["inner"]) == set(want["inner"])
    assert np.asarray(jck_state["master"]).shape == \
        np.asarray(jstate.master).shape
    np.testing.assert_array_equal(np.asarray(jck_state["master"]),
                                  state.master.numpy())


# -- two gloo ranks --------------------------------------------------------

@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    out = tmp_path_factory.mktemp("front_door")
    _, _, p_np = _jax_mlp()
    lm_params, tokens = _lm_data()
    launch_cpu_ranks(fw.matrix_worker, WORLD, str(out), p_np, _batch(),
                     lm_params, tokens)
    return torch.load(os.path.join(out, "matrix.pt"), weights_only=False)


@pytest.mark.parametrize("name", [p[0] for p in fw.DP_POINTS])
def test_world2_dp_point_tracks_the_oracle(matrix, name):
    _, _, p_np = _jax_mlp()
    rec = matrix["dp"][name]
    oracle = _oracle(p_np, _batch())
    rtol = QUANT_RTOL.get(name)
    if rtol is None:
        np.testing.assert_allclose(rec["losses"], oracle, **EXACT)
    else:
        np.testing.assert_allclose(rec["losses"], oracle, rtol=rtol,
                                   atol=rtol)
    assert all(n == 1 for n in rec["trace_counts"].values())
    if name.startswith("adaptive"):
        assert rec["widths"][:2] == [8, 8]
        assert set(rec["widths"]) <= {4, 8}
        assert len(rec["trace_counts"]) <= 2
    else:
        assert len(rec["trace_counts"]) == 1
    assert rec["in_eq_out"]


@pytest.mark.parametrize("rung", fw.RUNGS)
def test_world2_ladder_tracks_the_oracle(matrix, rung):
    _, _, p_np = _jax_mlp()
    rec = matrix["ladder"][rung]
    np.testing.assert_allclose(rec["losses"], _oracle(p_np, _batch()),
                               **EXACT)
    assert rec["compiles"] == 1 and rec["axes"] == {"dp": WORLD}
    assert rec["opt_eq"] and rec["params_eq"] and rec["verify"]


def test_world2_from_inputs_tracks_the_oracle(matrix):
    _, _, p_np = _jax_mlp()
    rec = matrix["from_inputs"]
    np.testing.assert_allclose(rec["losses"], _oracle(p_np, _batch()),
                               **EXACT)
    assert rec["compiles"] == 1 and rec["loss_dim"] == 0
    # the LM's flash path on DTensors == the plain step on the whole batch
    lm_params, tokens = _lm_data()
    model, opt = fw.lm(lm_params), fw.adamw()
    out = make_step(fw.lm_loss, opt, donate=False)(
        model, opt.init(model.parameters()), torch.from_numpy(tokens))
    np.testing.assert_allclose(matrix["from_inputs_lm"],
                               float(out.loss[0]), **EXACT)
    # the batch sharded along the sequence trains as JAX's step does:
    # its first loss is JAX's on the same weights and tokens, its second
    # the plain step's after one update
    jm = jmodels.TransformerLM(**fw.LM)
    x, y = tokens[:, :-1], tokens[:, 1:]
    jax_loss = float(jax_ce(jm.apply(lm_params, x).reshape(-1, fw.LM["vocab"]),
                            y.reshape(-1)))
    out2 = make_step(fw.lm_loss, opt, donate=False)(
        model, out.opt_state, torch.from_numpy(tokens))
    np.testing.assert_allclose(matrix["seq_sharded"],
                               [jax_loss, float(out2.loss[0])], **EXACT)


def test_world2_handoff_chain_moves_nothing(matrix):
    rec = matrix["chain"]
    assert rec["compiles"] == 1
    assert rec["pred_shape"] == (8, 17)        # the global batch
    assert rec["eval_traces"] == 1 and rec["eval_pinned"]
    assert rec["tokens"] == 4
    assert rec["reshards"] == {"redistribute": 0, "full_tensor": 0}
    assert [k for k, _ in matrix["refused"]] == ["engine", "generate",
                                                 "eval"]
    z = matrix["zero3_eval"]
    assert z["tree"] and z["pinned_is"] and z["traces"] == 1
    assert z["pred_shape"] == (16,)
    assert z["reshards"] == {"redistribute": 0, "full_tensor": 0}
    assert "Shard(dim=" in z["placements"]["lin1.weight"]
    assert matrix["zero3_plain_refused"] == "lin1.weight"


def test_world2_host_door_dispatch(tmp_path):
    _, _, p_np = _jax_mlp()
    launch_cpu_ranks(fw.host_worker, WORLD, str(tmp_path), p_np, _batch(),
                     backend="host")
    rec = torch.load(tmp_path / "host.pt", weights_only=False)
    oracle = _oracle(p_np, _batch())
    for name in ("mean", "sharded"):
        r = rec[name]
        np.testing.assert_allclose(r["losses"], oracle, rtol=2e-5,
                                   atol=1e-6)
        assert not r["front_door_step"] and r["host_times"]
        assert not r["again_same"]
    assert rec["cached"] == 0
    assert "pad_multiple" in rec["pad_multiple"]
