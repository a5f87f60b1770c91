"""The mesh, the FSDP spec trees and the ZeRO-1/2/3 ladder of the port
(``runtime/context.py``, ``parallel/fsdp.py``, ``optim/``) against the
JAX package, and the LM trainer's ``--fsdp``.

- The spec trees equal the JAX package's leaf for leaf:
  ``fsdp_param_specs`` at 1, 2, 4 and 8 shards, with and without the
  tensor-parallel ``base_specs``; ``opt_state_specs`` of adamw,
  ``adamw_8bit``, ``accumulate`` and ``with_master_f32`` (the port's
  per-parameter lists read through ``convert.jax_param_slots``).
- Two gloo CPU ranks (``_torch_fsdp_workers.ladder_worker``; a 2-layer,
  dim-64 LM from JAX weights, each rank on its half of every batch):
  ZeRO-1, ZeRO-2 and ZeRO-3 take 4 adamw steps and equal the port's
  replicated ``make_train_step`` on the whole batch (world 1) and JAX's
  replicated step on the same batches: float32, ``rtol=1e-5``,
  ``atol=1e-6`` on every loss and every final parameter, at
  ``adamw(3e-4, eps=1e-6)`` (FLAGSHIP's lr; ``_torch_fsdp_workers.EPS``
  says why not torch's eps of 1e-8: there Adam divides the ~1e-10
  rounding of a gradient that cancels, the key bias's, by ~eps, and an
  element moved 1.8e-6 apart from JAX's in 4 steps).
  So does ZeRO-3 of a ``tensor_parallel_lm`` model on the one-rank tp
  axis of the two-rank world (each tp collective the identity). Every
  state leaf sits where ``opt_state_specs`` puts it. Under ZeRO-3
  sgd (momentum) and ``with_clipping(sgd)`` (the global norm over every
  shard) equal the replicated step to the same tolerance; adafactor
  (its factored means over sharded dimensions) equals the replicated
  step at world 2 after one step, and in its losses over 4 steps (its
  update is normalised per element, so after the first step the
  rounding of its global means reaches the key bias's analytically
  zero gradient and flips signs there); ``adamw_8bit`` refuses
  a sharded parameter on every rung with the typed error naming its
  ROADMAP item. ``mixed_precision="bf16"`` under ZeRO-3 (FSDP2's
  ``MixedPrecisionPolicy``, float32 masters and reduction) against the
  replicated bf16 step: losses rtol 2e-3, parameters atol 1e-5 (bf16
  rounding of the forward, a few float32 ulps of the update).
- The trainer at world 2: ``--fsdp`` equals the run without it (losses
  and eval nll rtol 1e-5, the greedy tokens equal), and a ``--save`` /
  ``--resume`` round trip under ``--fsdp`` continues exactly; at world
  1 ``--fsdp`` is the plain step, bit for bit.

Serial run time ~60 s (three launches of two ranks and two of the
trainer).
"""

import jax
import numpy as np
import pytest
import torch

import _torch_fsdp_workers as fw
import distributed_pytorch_tpu as jdist
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu import optim as joptim
from distributed_pytorch_tpu.ops.losses import cross_entropy as jax_ce
from distributed_pytorch_tpu.parallel import fsdp as jfsdp
from distributed_pytorch_tpu.parallel import tensor as jtensor
from distributed_pytorch_tpu.parallel import \
    make_train_step as jax_make_train_step
from distributed_pytorch_tpu_torch import TransformerLM, optim
from distributed_pytorch_tpu_torch.convert import (jax_param_slots,
                                                   spec_placements)
from distributed_pytorch_tpu_torch.examples import train_transformer_lm
from distributed_pytorch_tpu_torch.parallel import (fsdp, make_train_step,
                                                    tensor)
from distributed_pytorch_tpu_torch.runtime import context

WORLD = 2
STEPS = 4
BATCH = 4                    # global; each rank trains on half


def _jax_lm(seed=0, **over):
    jm = jmodels.TransformerLM(**dict(fw.LM, **over))
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(seed)))
    return jm, params


def _batches(seed=1, n=STEPS):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, fw.LM["vocab"], (BATCH, fw.LM["max_seq"]))
                  .astype(np.int64) for _ in range(2)) for _ in range(n)]


def _plain(tree):
    """A spec tree of either package as nested dicts, lists, tuples
    tagged with their type, and ("P", entries...) at each spec."""
    if isinstance(tree, (tensor.P, jax.sharding.PartitionSpec)):
        return ("P",) + tuple(tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__,) + tuple(_plain(v) for v in tree)
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def _port_model(**over):
    return TransformerLM(device="cpu", **dict(fw.LM, **over))


# -- the spec trees ---------------------------------------------------------

@pytest.mark.parametrize("base", [False, True], ids=["plain", "tp_base"])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_fsdp_param_specs_equal_jax(n_shards, base):
    jm, params = _jax_lm()
    pm = _port_model()
    kw = {}
    if base:
        kw = dict(base_specs=jtensor.transformer_lm_param_specs(jm))
    want = jfsdp.fsdp_param_specs(params, n_shards, **kw)
    if base:
        kw = dict(base_specs=tensor.transformer_lm_param_specs(pm))
    got = fsdp.fsdp_param_specs(pm, n_shards, **kw)
    assert _plain(got) == _plain(want)
    # a tree of arrays in the JAX layout reads as the module does
    assert _plain(fsdp.fsdp_param_specs(params, n_shards, **kw)) \
        == _plain(want)


def _port_specs_as_jax(state_specs, model):
    """The port's spec state with each per-parameter list laid out as
    the JAX param tree (through the slots)."""
    slots = jax_param_slots(model)
    n = len(list(model.parameters()))

    def conv(node):
        if isinstance(node, list) and len(node) == n:
            return tensor.tree_map(lambda s: _plain(node[s.index]), slots)
        if isinstance(node, tensor.P):
            return _plain(node)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return (type(node).__name__,) + tuple(conv(v) for v in node)
        return [conv(v) for v in node]
    return conv(state_specs)


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "accumulate",
                                  "master_f32"])
def test_opt_state_specs_equal_jax(name):
    jm, params = _jax_lm()
    pm = _port_model()
    make = {"adamw": lambda o: o.adamw(1e-3),
            "adamw8bit": lambda o: o.adamw_8bit(1e-3),
            "accumulate": lambda o: o.accumulate(o.adamw(1e-3), 2),
            "master_f32": lambda o: o.with_master_f32(o.adamw(1e-3))}[name]
    jstate = make(joptim).init(jax.tree_util.tree_map(jax.numpy.asarray,
                                                      params))
    want = jfsdp.opt_state_specs(jstate, jfsdp.fsdp_param_specs(params, 2),
                                 params=params)
    pstate = make(optim).init(pm.parameters())
    got = fsdp.opt_state_specs(pstate, fsdp.fsdp_param_specs(pm, 2), pm)
    assert _port_specs_as_jax(got, pm) == _plain(want)
    # and shard_layouts hands out the same pair
    p_specs, o_specs, axes = fsdp.shard_layouts(pm, pstate, n_shards=2)
    assert axes == {"dp": 2} and _plain(o_specs) == _plain(got)
    assert _plain(p_specs) == _plain(fsdp.fsdp_param_specs(pm, 2))


def test_a_spec_maps_onto_the_port_layout():
    pm = _port_model()
    slots = jax_param_slots(pm)
    from torch.distributed.tensor import Replicate, Shard
    qkv = slots["blocks"][0]["attn"]["qkv"]
    # JAX (D, 3D) column split is the port's (3D, D) row split
    assert spec_placements(tensor.P(None, "tp"), qkv["w"], ("tp",)) \
        == (Shard(0),)
    assert spec_placements(tensor.P("dp", "tp"), qkv["w"], ("dp", "tp")) \
        == (Shard(1), Shard(0))
    assert spec_placements(tensor.P("tp"), qkv["b"], ("dp", "tp")) \
        == (Replicate(), Shard(0))
    assert spec_placements(tensor.P(), slots["tok"]["emb"], ("dp",)) \
        == (Replicate(),)
    with pytest.raises(ValueError, match="names axis 'sp'"):
        spec_placements(tensor.P("sp"), qkv["b"], ("dp",))


# -- the mesh ---------------------------------------------------------------

def test_mesh_outside_a_group():
    mesh = context.get_mesh()
    assert mesh.mesh_dim_names == ("dp",) and mesh.size() == 1
    assert context.MESH_AXES == ("dp", "tp", "sp", "pp", "ep")
    from torch.distributed.tensor import Replicate, Shard
    assert context.batch_sharding() == (Shard(0),)
    assert context.replicated_sharding() == (Replicate(),)
    with pytest.raises(ValueError,
                       match=r"mesh 2x1x1x1x1=2 does not match 1 visible"):
        context.init_mesh(dp=2)


# -- the ladder at world 2 ----------------------------------------------------

@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    jm, params = _jax_lm(seed=3)
    batches = _batches()
    out = tmp_path_factory.mktemp("fsdp_ladder")
    launch_cpu_ranks(fw.ladder_worker, WORLD, str(out), params, batches)
    rec = torch.load(out / "ladder.pt", weights_only=False)
    return {"rec": rec, "jm": jm, "params": params, "batches": batches}


def _port_world1(params, batches, opt_name, steps, mp="off"):
    """The port's replicated step at world 1 on the whole batches."""
    model = fw.build(params)
    opt = fw.optimizer(opt_name)
    step = make_train_step(fw.lm_loss, opt, mixed_precision=mp)
    losses, _, snaps = fw._run(step, model, opt.init(model.parameters()),
                               batches[:steps], 0, 1, after=(1, steps))
    return {"losses": losses, "params": snaps}


@pytest.fixture(scope="module")
def world1(ladder):
    return _port_world1(ladder["params"], ladder["batches"], "adamw", STEPS)


@pytest.fixture(scope="module")
def jax_world1(ladder):
    jm = ladder["jm"]

    def loss_fn(p, batch):
        x, y = batch
        return jax_ce(jm.apply(p, x).astype(jax.numpy.float32), y), {}

    opt = joptim.adamw(fw.LR, eps=fw.EPS)
    params = jax.tree_util.tree_map(jax.numpy.asarray, ladder["params"])
    jparams, jstate = jdist.replicate(params), jdist.replicate(
        opt.init(params))
    step = jax_make_train_step(loss_fn, opt)
    losses = []
    for x, y in ladder["batches"]:
        jparams, jstate, loss, _ = step(jparams, jstate,
                                        jdist.shard_batch((x, y)))
        losses.append(float(np.asarray(loss).mean()))
    return {"losses": losses,
            "params": jax.tree_util.tree_map(np.asarray, jparams)}


def _assert_trees_close(got, want, rtol=1e-5, atol=1e-6):
    gl = jax.tree_util.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("case", ["rep", "zero1", "zero2", "zero3",
                                  "zero3_tp1"])
def test_ladder_equals_the_replicated_step_and_jax(ladder, world1,
                                                   jax_world1, case):
    got = ladder["rec"][case]
    assert len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], world1["losses"], rtol=1e-5,
                               atol=1e-6)
    _assert_trees_close(got["params"][STEPS], world1["params"][STEPS])
    np.testing.assert_allclose(got["losses"], jax_world1["losses"],
                               rtol=1e-5, atol=1e-6)
    _assert_trees_close(got["params"][STEPS], jax_world1["params"])


@pytest.mark.parametrize("case", ["zero1", "zero2", "zero3"])
def test_state_leaves_sit_where_opt_state_specs_puts_them(ladder, case):
    layout = ladder["rec"][case]["state_layout"]
    for field in ("mu", "nu"):
        got, want = layout[field]
        assert got == want
    # the layout really shards: some leaves split over dp, some not
    assert any("Shard" in g for g in layout["mu"][0])
    assert any("Replicate" in g for g in layout["mu"][0])


def test_zero3_places_parameters_by_the_specs(ladder):
    rec = ladder["rec"]["zero3"]
    pm = fw.build(ladder["params"])
    slots = [s for s, _ in tensor.specs_by_param(pm, rec["fsdp_specs"])]
    specs = [sp for _, sp in tensor.specs_by_param(pm, rec["fsdp_specs"])]
    for got, slot, spec in zip(rec["param_placements"], slots, specs):
        if "dp" in tuple(spec):
            assert got == str(spec_placements(spec, slot, ("dp",)))
        else:
            assert got == "plain"      # left out of fully_shard


@pytest.mark.parametrize("case,opt_name", [("zero3_sgd", "sgd"),
                                           ("zero3_clip_sgd", "clip_sgd")])
def test_zero3_sgd_and_clipping_equal_the_replicated_step(ladder, case,
                                                          opt_name):
    want = _port_world1(ladder["params"], ladder["batches"], opt_name, STEPS)
    got = ladder["rec"][case]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)
    _assert_trees_close(got["params"][STEPS], want["params"][STEPS])


def test_zero3_adafactor_uses_global_statistics(ladder):
    want = ladder["rec"]["rep_adafactor"]
    got = ladder["rec"]["zero3_adafactor"]
    _assert_trees_close(got["params"][1], want["params"][1])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)


def test_adamw_8bit_refuses_a_sharded_parameter(ladder):
    for rung, msg in ladder["rec"]["adamw8bit"].items():
        assert msg is not None, rung
        assert "Queue A item 5.7" in msg and "adamw_8bit" in msg


def test_zero3_bf16_policy_equals_the_replicated_bf16_step(ladder):
    rec = ladder["rec"]
    want, got = rec["rep_bf16"], rec["zero3_bf16"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-3)
    _assert_trees_close(got["params"][2], want["params"][2], rtol=0,
                        atol=1e-5)


# -- the trainer ------------------------------------------------------------

ARGS = ["--device", "cpu", "--dim", "64", "--n-layers", "2", "--n-heads",
        "4", "--seq-len", "32", "--batch-size", "2", "--data-size", "64",
        "--log-every", "1", "--eval", "--generate", "4"]


def _trainer(tmp_path, name, argv):
    out = tmp_path / name
    out.mkdir()
    launch_cpu_ranks(train_transformer_lm.main_worker, WORLD, ARGS + argv,
                     True, None, str(out))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_trainer_fsdp_equals_plain_and_resumes_exactly(tmp_path):
    ck = str(tmp_path / "ck")
    plain = _trainer(tmp_path, "plain", ["--steps", "8"])
    first = _trainer(tmp_path, "first", ["--steps", "5", "--fsdp", "--save",
                                         ck, "--save-every", "2"])
    resumed = _trainer(tmp_path, "resumed", ["--steps", "8", "--fsdp",
                                             "--save", ck, "--resume"])
    for r in range(WORLD):
        assert first[r]["fsdp"] and resumed[r]["fsdp"]
        assert not plain[r]["fsdp"]
        assert resumed[r]["start_step"] == 5
        losses = first[r]["losses"] + resumed[r]["losses"]
        np.testing.assert_allclose(losses, plain[r]["losses"], rtol=1e-5)
        np.testing.assert_allclose(resumed[r]["eval_nll"],
                                   plain[r]["eval_nll"], rtol=1e-5)
        assert resumed[r]["generated"] == plain[r]["generated"]
    # the resumed run continues the uninterrupted --fsdp run exactly
    whole = _trainer(tmp_path, "whole", ["--steps", "8", "--fsdp"])
    for r in range(WORLD):
        assert resumed[r]["losses"] == whole[r]["losses"][5:]


def test_trainer_fsdp_at_world1_is_the_plain_step():
    argv = ARGS + ["--steps", "3"]
    plain = train_transformer_lm.main_worker(0, 1, argv, quiet=True)
    sharded = train_transformer_lm.main_worker(0, 1, argv + ["--fsdp"],
                                               quiet=True)
    assert not sharded["fsdp"]
    assert sharded["losses"] == plain["losses"]
    assert sharded["eval_nll"] == plain["eval_nll"]
