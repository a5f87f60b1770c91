"""Tensor parallelism of the port (``parallel/tensor.py``) and the
vocab-parallel loss (``ops/losses.py``) against the JAX package and the
unsharded model.

- ``transformer_lm_param_specs`` equals the JAX package's leaf for
  leaf, with a head and with tied embeddings.
- Two gloo CPU ranks, tp = 2 (``_torch_fsdp_workers.tp_worker``):
  ``vocab_parallel_cross_entropy`` on each rank's half of seeded (2, 8,
  64) logits equals the dense cross-entropy, value and gradient
  (``atol=1e-5``), and a label no shard owns (past the vocab, or -100)
  is NaN. ``tensor_parallel_lm`` of the 2-layer, dim-64 LM (JAX
  weights): its parameters sit where the spec tree puts them, its
  logits and the vocab-parallel loss of its hidden states equal the
  unsharded model's logits and dense loss (``atol=1e-5``), and the
  gradients of every parameter equal the unsharded model's
  (``atol=1e-5``, float32), untied and tied. One split forward makes,
  per layer, one all-gather (the qkv projection to head-local q, k, v)
  and two all-reduces (after out and fc2), plus the logits'
  all-gather; the backward adds per layer one reduce-scatter (the qkv
  gradient) and two all-reduces (the gradients entering qkv and fc1).
- Four gloo CPU ranks, dp 2 x tp 2 (``fsdp_tp_worker``):
  ``tensor_parallel_lm``, ZeRO-3 by ``fsdp_param_specs(...,
  base_specs=transformer_lm_param_specs(model))`` and the
  vocab-parallel loss take 4 ``adamw(3e-4, eps=1e-6)`` steps and equal
  the port's replicated step on the whole batches (losses and final
  parameters ``rtol=1e-5``, ``atol=1e-6``); every parameter and moment
  carries the dp and tp placements of its spec.

Serial run time ~25 s.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_fsdp_workers as fw
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu.parallel import tensor as jtensor
from distributed_pytorch_tpu_torch import TransformerLM
from distributed_pytorch_tpu_torch.comm import primitives as prim
from distributed_pytorch_tpu_torch.convert import spec_placements
from distributed_pytorch_tpu_torch.ops.losses import (
    cross_entropy, cross_entropy_per_example, vocab_parallel_cross_entropy)
from distributed_pytorch_tpu_torch.parallel import make_train_step, tensor
from test_torch_fsdp import _assert_trees_close, _batches, _jax_lm, _plain

TP = 2


@pytest.mark.parametrize("tied", [False, True], ids=["head", "tied"])
def test_transformer_lm_param_specs_equal_jax(tied):
    jm = jmodels.TransformerLM(tie_embeddings=tied, **fw.LM)
    pm = TransformerLM(device="cpu", tie_embeddings=tied, **fw.LM)
    want = jtensor.transformer_lm_param_specs(jm)
    assert _plain(tensor.transformer_lm_param_specs(pm)) == _plain(want)
    assert _plain(tensor.transformer_lm_param_specs(pm, "model")) \
        == _plain(jtensor.transformer_lm_param_specs(jm, "model"))
    jparams = jm.init(jax.random.PRNGKey(0))
    assert _plain(tensor.replicated_specs(pm)) \
        == _plain(jtensor.replicated_specs(jparams))


def test_primitives_outside_a_group():
    x = torch.arange(4.0)
    assert prim.axis_index() == 0 and prim.axis_size() == 1
    assert prim.psum(x) is x and prim.pmax(x) is x
    # no tp axis on the live mesh: the logits are the whole vocab
    logits = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([0, 4, 2])
    np.testing.assert_allclose(
        vocab_parallel_cross_entropy(logits, ids).numpy(),
        cross_entropy_per_example(logits, ids).numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    _, params = _jax_lm(seed=5)
    _, tied = _jax_lm(seed=6, tie_embeddings=True)
    rng = np.random.default_rng(7)
    batch = tuple(rng.integers(0, fw.LM["vocab"], (2, fw.LM["max_seq"]))
                  .astype(np.int64) for _ in range(2))
    labels = {"logits": rng.standard_normal((2, 8, 64)).astype(np.float32)
              * 3, "ids": rng.integers(0, 64, (2, 8)).astype(np.int64)}
    out = tmp_path_factory.mktemp("tp")
    launch_cpu_ranks(fw.tp_worker, TP, str(out), params, tied, batch,
                     labels)
    rec = torch.load(out / "tp.pt", weights_only=False)
    return {"rec": rec, "params": params, "tied": tied, "batch": batch,
            "labels": labels}


def test_vocab_parallel_ce_equals_the_dense_ce(tp_run):
    lab = tp_run["labels"]
    logits = torch.from_numpy(lab["logits"]).requires_grad_(True)
    ids = torch.from_numpy(lab["ids"])
    dense = cross_entropy_per_example(logits, ids)
    dense.sum().backward()
    rec = tp_run["rec"]
    np.testing.assert_allclose(rec["ce"], dense.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(rec["ce_grad"], logits.grad.numpy(),
                               atol=1e-5)
    assert rec["rank_and_size"] == (0, TP)


def test_a_label_no_shard_owns_is_nan(tp_run):
    got = tp_run["rec"]["ce_unowned"]
    assert np.isnan(got[0, 0]) and np.isnan(got[0, 1])
    assert np.isfinite(got[0, 2:]).all() and np.isfinite(got[1]).all()


@pytest.mark.parametrize("name", ["untied", "tied"])
def test_tensor_parallel_lm_equals_the_unsharded_model(tp_run, name):
    rec = tp_run["rec"]
    over = {"tie_embeddings": True} if name == "tied" else {}
    model = fw.build(tp_run[name if name == "tied" else "params"], **over)
    x, y = (torch.from_numpy(t) for t in tp_run["batch"])
    logits = model(x)
    (2 * cross_entropy(logits, y)).backward()
    np.testing.assert_allclose(rec[f"{name}_logits"],
                               logits.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(
        rec[f"{name}_vp_ce"],
        cross_entropy_per_example(logits, y).detach().numpy(), atol=1e-5)
    grads = rec[f"{name}_grads"]
    assert set(grads) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        np.testing.assert_allclose(grads[n], p.grad.numpy(), atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("name", ["untied", "tied"])
def test_parameters_sit_where_the_specs_put_them(tp_run, name):
    over = {"tie_embeddings": True} if name == "tied" else {}
    model = fw.build(tp_run[name if name == "tied" else "params"], **over)
    specs = tensor.transformer_lm_param_specs(model)
    names = [n for n, _ in model.named_parameters()]
    got = tp_run["rec"][f"{name}_placements"]
    for n, (slot, spec) in zip(names, tensor.specs_by_param(model, specs)):
        assert got[n] == str(spec_placements(spec, slot, ("tp",))), n
    # the fused qkv is split by rows of (3D, D): columns of JAX's (D, 3D)
    assert got["blocks.0.attn.qkv.weight"] == "(Shard(dim=0),)"
    assert got["blocks.0.attn.out.weight"] == "(Shard(dim=1),)"


def test_the_split_costs_one_gather_and_two_reduces_per_layer(tp_run):
    n = fw.LM["n_layers"]
    assert tp_run["rec"]["forward_collectives"] == {
        "all_gather": n + 1, "psum": 2 * n}
    assert tp_run["rec"]["train_collectives"] == {
        "all_gather": n + 1, "psum": 4 * n + 1, "reduce_scatter": n}


@pytest.fixture(scope="module")
def fsdp_tp_run(tmp_path_factory):
    _, params = _jax_lm(seed=8)
    batches = _batches(seed=9)
    out = tmp_path_factory.mktemp("fsdp_tp")
    launch_cpu_ranks(fw.fsdp_tp_worker, 4, str(out), params, batches)
    rec = torch.load(out / "fsdp_tp.pt", weights_only=False)
    return {"rec": rec, "params": params, "batches": batches}


def test_dp2_tp2_equals_the_replicated_step(fsdp_tp_run):
    want = _port_world1_dense(fsdp_tp_run["params"],
                              fsdp_tp_run["batches"])
    got = fsdp_tp_run["rec"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)
    steps = len(fsdp_tp_run["batches"])
    _assert_trees_close(got["params"], want["params"][steps])


def _port_world1_dense(params, batches):
    model = fw.build(params)
    opt = fw.optimizer("adamw")
    step = make_train_step(fw.lm_loss, opt)
    losses, _, snaps = fw._run(step, model, opt.init(model.parameters()),
                               batches, 0, 1, after=(len(batches),))
    return {"losses": losses, "params": snaps}


def test_dp2_tp2_places_params_and_state_by_dp_and_tp(fsdp_tp_run):
    rec = fsdp_tp_run["rec"]
    model = fw.build(fsdp_tp_run["params"])
    names = [n for n, _ in model.named_parameters()]
    pairs = tensor.specs_by_param(model, rec["specs"])
    for i, (n, (slot, spec)) in enumerate(zip(names, pairs)):
        want = str(spec_placements(spec, slot, ("dp", "tp")))
        assert rec["state_placements"][i] == want, n
        if "dp" in tuple(spec):
            assert rec["placements"][n] == want, n
        else:                 # left out of fully_shard: the tp layout only
            assert rec["placements"][n] == str(
                spec_placements(spec, slot, ("tp",))), n
    assert rec["placements"]["blocks.0.attn.qkv.weight"] \
        == "(Shard(dim=1), Shard(dim=0))"
