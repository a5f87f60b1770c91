"""Expert parallelism of the port (``parallel/moe.py``,
``models/moe_lm.py``) against the JAX package.

- ``MoELayer`` with the JAX layer's weights (``convert``): top-1 with
  ample and scarce capacity, top-2, GShard priority of first choices
  (the JAX suite's two-token case), identical tokens over capacity,
  expert-choice, shared experts, and tied router scores (a zero gate:
  ranked lower index first, as ``jax.lax.top_k``): the output, every
  metric and the gradients of x and of every parameter against JAX's
  (``rtol 2e-3, atol 2e-4``, as ``tests/test_pipeline_moe.py``); bf16
  parameters route and run the experts in f32 as JAX's do.
- ``MoETransformerLM`` (top-2, a shared expert): logits, aux, metrics
  and every gradient of ``nll + 0.01 aux`` against JAX's; the
  parameters round-trip through ``to_jax_params``.
- Four gloo ranks at dp 2 x ep 2 (``_torch_sp_workers.moe_ep_worker``):
  each rank routes its 2 of the 4 sequences and holds 2 of the 4
  experts (``Shard(0)`` over ep); 3 adamw steps (eps 1e-6,
  ``_torch_fsdp_workers.EPS`` says why) equal the port's replicated
  step at world 1 (losses ``rtol 1e-5``, final parameters ``atol
  1e-5``) and JAX's first loss; the expert-choice router's loss and
  gradients equal world 1's; the collectives of a layer counted
  (``parallel/moe.py``'s docstring lists them).
- ``examples/train_moe_lm.py`` at ep 2 (two ranks) equals the JAX
  example at dp 4 x ep 2 (same weights).

Serial run time ~80 s.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sp_workers as sw
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu.ops.losses import \
    cross_entropy_per_example as jax_ce
from distributed_pytorch_tpu.parallel.moe import MoELayer as JMoE
from distributed_pytorch_tpu_torch import from_jax_params, to_jax_params
from distributed_pytorch_tpu_torch.parallel.moe import MoELayer

TOL = dict(rtol=2e-3, atol=2e-4)
METRICS = ("aux_loss", "z_loss", "drop_rate", "expert_load")

# name -> (layer kwargs, x shape or an explicit x, gate override)
LAYER_CASES = {
    "top1_ample": (dict(dim=8, n_experts=4, mlp_ratio=2,
                        capacity_factor=4.0), (16, 8), None),
    "top1_scarce": (dict(dim=8, n_experts=4, mlp_ratio=2,
                         capacity_factor=0.5), (2, 12, 8), None),
    "top2": (dict(dim=8, n_experts=4, mlp_ratio=2, top_k=2,
                  capacity_factor=1.0), (3, 8, 8), None),
    "priority": (dict(dim=2, n_experts=2, mlp_ratio=2, capacity_factor=0.5,
                      top_k=2), np.array([[1.0, 2.0], [2.0, 1.0]],
                                         np.float32),
                 np.array([[4.0, 0.0], [0.0, 4.0]], np.float32)),
    "identical_over_capacity": (dict(dim=4, n_experts=2,
                                     capacity_factor=0.125),
                                np.tile(np.array([[1.0, 2.0, 3.0, 4.0]],
                                                 np.float32), (16, 1)),
                                None),
    "expert_choice": (dict(dim=8, n_experts=4, mlp_ratio=2,
                           router="experts", capacity_factor=1.0),
                      (2, 8, 8), None),
    "shared_top2": (dict(dim=8, n_experts=4, mlp_ratio=2, top_k=2,
                         n_shared_experts=2), (12, 8), None),
    "tied_scores": (dict(dim=8, n_experts=4, mlp_ratio=2, top_k=2,
                         capacity_factor=1.0), (10, 8),
                    np.zeros((8, 4), np.float32)),
    "tied_expert_choice": (dict(dim=8, n_experts=4, mlp_ratio=2,
                                router="experts", capacity_factor=0.5),
                           (10, 8), np.zeros((8, 4), np.float32)),
}


def _layer_pair(kw, x, gate, seed=3):
    jl = JMoE(**kw)
    params = jax.tree_util.tree_map(np.asarray,
                                    jl.init(jax.random.PRNGKey(seed)))
    if gate is not None:
        params["gate"]["w"] = gate
    if not isinstance(x, np.ndarray):
        x = np.random.default_rng(seed).standard_normal(x) \
            .astype(np.float32)
    pl = from_jax_params(params, MoELayer(device="cpu", **kw))
    return jl, params, pl, x


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_moe_layer_equals_jax(name):
    kw, x, gate = LAYER_CASES[name]
    jl, params, pl, x = _layer_pair(kw, x, gate)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, m = jl.apply_with_metrics(p, xx)
        return jnp.sum(y * w) + m["aux_loss"] + 0.1 * m["z_loss"], (y, m)
    (_, (yj, mj)), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    yp, mp = pl.forward_with_metrics(xt)
    ((yp * torch.from_numpy(w)).sum() + mp["aux_loss"]
     + 0.1 * mp["z_loss"]).backward()
    np.testing.assert_allclose(yp.detach().numpy(), np.asarray(yj), **TOL)
    for k in METRICS:
        np.testing.assert_allclose(mp[k].detach().numpy(),
                                   np.asarray(mj[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    got = to_jax_params(pl, grads=True)
    for (path, g), want in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves(gp)):
        np.testing.assert_allclose(g, np.asarray(want),
                                   err_msg=jax.tree_util.keystr(path),
                                   **TOL)
    load = mp["expert_load"].detach().numpy()
    if float(mp["drop_rate"]) < 1.0:
        np.testing.assert_allclose(load.sum(), 1.0, rtol=1e-6)


def test_priority_case_keeps_first_choices():
    """The JAX suite's case: t1's first choice takes E0's one slot ahead
    of t0's second choice; half the dispatches drop."""
    kw, x, gate = LAYER_CASES["priority"]
    _, _, pl, x = _layer_pair(kw, x, gate)
    _, m = pl.forward_with_metrics(torch.from_numpy(x))
    assert float(m["drop_rate"]) == pytest.approx(0.5)
    np.testing.assert_allclose(m["expert_load"].numpy(), [0.5, 0.5])


def test_bf16_parameters_route_in_f32():
    kw = dict(dim=16, n_experts=4, mlp_ratio=2, top_k=2)
    jl = JMoE(dtype=jnp.bfloat16, **kw)
    params = jl.init(jax.random.PRNGKey(4))
    x = np.random.default_rng(4).standard_normal((2, 8, 16)) \
        .astype(np.float32)
    yj, mj = jl.apply_with_metrics(params, jnp.asarray(x, jnp.bfloat16))
    p_np = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  params)
    pl = from_jax_params(p_np, MoELayer(device="cpu", dtype=torch.bfloat16,
                                        **kw))
    yp, mp = pl.forward_with_metrics(torch.from_numpy(x).to(torch.bfloat16))
    assert yp.dtype == torch.bfloat16
    np.testing.assert_allclose(yp.detach().float().numpy(),
                               np.asarray(yj, np.float32), rtol=2e-2,
                               atol=2e-2)
    for k in METRICS:
        np.testing.assert_allclose(mp[k].detach().float().numpy(),
                                   np.asarray(mj[k], np.float32),
                                   err_msg=k, rtol=2e-2, atol=2e-3)


def test_rejected_arguments_are_jax_value_errors():
    for kw in (dict(top_k=5), dict(top_k=0), dict(router="bogus"),
               dict(n_shared_experts=-1)):
        with pytest.raises(ValueError):
            JMoE(8, 4, **kw)
        with pytest.raises(ValueError):
            MoELayer(8, 4, device="cpu", **kw)


LM_KW = dict(vocab=31, dim=16, n_layers=2, n_heads=2, n_experts=4,
             max_seq=16, top_k=2, n_shared_experts=1, capacity_factor=1.0)


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_moe_lm_logits_aux_and_gradients_equal_jax(pos):
    from distributed_pytorch_tpu_torch.models import MoETransformerLM
    jm = jmodels.MoETransformerLM(pos=pos, **LM_KW)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(1)))
    pm = from_jax_params(params, MoETransformerLM(device="cpu", pos=pos,
                                                  **LM_KW))
    for a, b in zip(jax.tree_util.tree_leaves(to_jax_params(pm)),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    toks = np.random.default_rng(1).integers(0, 31, (2, 17))
    x, y = toks[:, :-1], toks[:, 1:]

    def jloss(p):
        logits, aux, m = jm.apply_with_metrics(p, jnp.asarray(x))
        return jnp.mean(jax_ce(logits, jnp.asarray(y))) + 0.01 * aux, \
            (logits, aux, m)
    (_, (lj, aj, mj)), gj = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    logits, aux, m = pm.forward_with_metrics(torch.from_numpy(x))
    from distributed_pytorch_tpu_torch.ops.losses import \
        cross_entropy_per_example
    (cross_entropy_per_example(logits, torch.from_numpy(y)).mean()
     + 0.01 * aux).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(lj),
                               **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(aj), **TOL)
    for k in METRICS:
        np.testing.assert_allclose(m[k].detach().numpy(), np.asarray(mj[k]),
                                   err_msg=k, **TOL)
    got = to_jax_params(pm, grads=True)
    for (path, g), want in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree_util.tree_leaves(gj)):
        np.testing.assert_allclose(g, np.asarray(want),
                                   err_msg=jax.tree_util.keystr(path),
                                   **TOL)


def _moe_lm_params():
    jm = jmodels.MoETransformerLM(**sw.MOE_LM)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(2)))
    toks = np.random.default_rng(2).integers(
        0, sw.MOE_LM["vocab"], (4, sw.MOE_LM["max_seq"] + 1)) \
        .astype(np.int64)
    return jm, params, toks


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    _, params, toks = _moe_lm_params()
    out = tmp_path_factory.mktemp("moe_ep")
    launch_cpu_ranks(sw.moe_ep_worker, 4, str(out), params, toks, 2, 2,
                     timeout_s=180)
    return torch.load(out / "moe_ep.pt", weights_only=False)


def test_ep2_equals_the_replicated_step_and_jax(ep_run):
    jm, params, toks = _moe_lm_params()
    x, y = toks[:, :-1], toks[:, 1:]
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    losses, drops, final = sw.moe_train(sw.moe_lm(params), batch)
    np.testing.assert_allclose(ep_run["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(ep_run["drops"], drops, rtol=1e-6)
    assert set(ep_run["params"]) == set(final)
    # the parameters to 1e-5: 1% of one adamw step of lr 1e-3 (the ranks
    # sum the experts' and the tokens' parts in another order than one
    # rank does)
    for n, want in final.items():
        np.testing.assert_allclose(ep_run["params"][n], want, rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    logits, aux = jax.jit(jm.apply)(params, jnp.asarray(x))
    jax_loss = float(jnp.mean(jax_ce(logits, jnp.asarray(y))) + 0.01 * aux)
    np.testing.assert_allclose(ep_run["losses"][0], jax_loss, rtol=2e-5)
    assert 0.0 < drops[0] < 1.0          # capacity 1.0 at top-2 drops some
    # expert-choice: each expert's top tokens of the whole batch, ranked
    # from the scores gathered over dp
    got = ep_run["experts"]
    want = sw.moe_grads(sw.moe_lm(params, router="experts"), batch)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["drop_rate"] == want["drop_rate"]
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_ep2_holds_half_the_experts_and_counts_its_collectives(ep_run):
    e, d, h = sw.MOE_LM["n_experts"], sw.MOE_LM["dim"], 4 * sw.MOE_LM["dim"]
    assert ep_run["local_fc1"] == (e // 2, d, h)
    # on the (dp, ep) mesh: P("ep", None, "tp"), the one-rank tp left out
    assert ep_run["fc1_placements"] == "(Replicate(), Shard(dim=0))"
    assert ep_run["local_tokens"] == (2, sw.MOE_LM["max_seq"])
    n = sw.MOE_LM["n_layers"]
    # forward: the choice counts and the slots all-gathered over dp, the
    # slots reduce-scattered over dp, the loss sums over dp and the
    # routed output over ep all-reduced
    assert ep_run["forward_collectives"] == {
        "all_gather": 2 * n, "reduce_scatter": n, "psum": 2 * n}
    # backward adds the slots' swapped pair and the two ep copies
    assert ep_run["train_collectives"] == {
        "all_gather": 3 * n, "reduce_scatter": 2 * n, "psum": 4 * n}


def test_moe_example_history_equals_jax(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import train_moe_lm as jex
    args = ["--steps", "4", "--seq-len", "16", "--batch-size", "4",
            "--ep", "2", "--n-experts", "4", "--dim", "32",
            "--n-layers", "1", "--n-heads", "4", "--top-k", "2"]
    want = []
    jex.main(args, quiet=True, history=want)
    jm = jmodels.MoETransformerLM(vocab=256, dim=32, n_layers=1, n_heads=4,
                                  n_experts=4, max_seq=16, top_k=2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    launch_cpu_ranks(sw.example_worker, 2, str(tmp_path), "train_moe_lm",
                     args + ["--device", "cpu"], params, timeout_s=180)
    rec = torch.load(tmp_path / "train_moe_lm.pt", weights_only=False)
    assert rec["mesh"] == {"dp": 1, "ep": 2}
    assert len(rec["history"]) == 3
    np.testing.assert_allclose(rec["history"], want, rtol=5e-4, atol=5e-4)
    assert all(0.0 <= m["drop_rate"] <= 1.0 for m in rec["metrics"])


def test_param_specs_equal_jax_and_map_onto_placements():
    """``MoETransformerLM.param_specs`` equals JAX's leaf for leaf, and
    ``spec_placements`` puts the expert banks' ``P("ep", ...)`` on their
    leading (expert) dimension, untransposed."""
    from distributed_pytorch_tpu_torch.convert import (jax_param_slots,
                                                       spec_placements)
    from distributed_pytorch_tpu_torch.models import MoETransformerLM
    from distributed_pytorch_tpu_torch.parallel.tensor import tree_map
    jm = jmodels.MoETransformerLM(**LM_KW)
    pm = MoETransformerLM(device="cpu", **LM_KW)

    def plain(tree):
        return jax.tree_util.tree_map(
            lambda s: tuple(s), tree,
            is_leaf=lambda s: type(s).__name__ in ("P", "PartitionSpec"))
    assert plain(tree_map(lambda s: s, pm.param_specs())) == \
        plain(jm.param_specs())
    slots = jax_param_slots(pm)
    specs = pm.param_specs()
    moe_slots, moe_specs = slots["blocks"][0]["moe"], \
        specs["blocks"][0]["moe"]
    axes = ("tp", "ep")
    got = {name: str(spec_placements(moe_specs[name]["w"],
                                     moe_slots[name]["w"], axes))
           for name in ("fc1", "fc2")}
    assert got == {"fc1": "(Shard(dim=2), Shard(dim=0))",
                   "fc2": "(Shard(dim=1), Shard(dim=0))"}
    # the gate (a Linear, transposed) and the shared experts replicate
    # over ep; the shared fc1 shards its hidden (the weight's dim 0)
    assert str(spec_placements(moe_specs["gate"]["w"],
                               moe_slots["gate"]["w"], axes)) \
        == "(Replicate(), Replicate())"
    assert str(spec_placements(moe_specs["shared"]["fc1"]["w"],
                               moe_slots["shared"]["fc1"]["w"], axes)) \
        == "(Shard(dim=0), Replicate())"
