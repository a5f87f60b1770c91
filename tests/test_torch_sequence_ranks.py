"""Sequence parallelism of the port over gloo CPU ranks, against the JAX
package.

- World 4 (``_torch_sp_workers.seq_worker``): ``ppermute``,
  ``ring_shift`` (+1, -1, +2), ``line_shift`` (+1, -1; the rank with no
  sender gets zeros) and ``all_to_all``, values and gradients (the
  inverse permutation / the all-to-all back) against numpy; every core
  at sp 4 (the dense ring with GQA, the flash ring causal / non-causal /
  window 20, the striped ring on striped data, Ulysses) on each rank's
  sequence block, output and q/k/v gradients against JAX's
  ``shard_map`` of the same function (values ``2e-5``, gradients
  ``5e-4``, as ``tests/test_sequence_parallel.py``); Ulysses refuses
  heads that do not divide the axis; dp 2 x sp 2 ``FROM_INPUTS`` steps
  of the JAX suite's ``test_dp_tp_sp_mesh_train_step`` LM on a batch
  placed ``P("dp", "sp")`` (dense and flash rings), the first loss
  against JAX's within 2e-5, the four against JAX's adamw trajectory
  within 5e-4; at dp 4 x sp 1 (the step's mesh leaves the sp axis out)
  the flash ring's first loss against JAX's.
- ``examples/train_long_context.py`` at dp 1 x sp 2 (two ranks) equals
  the JAX example at dp 4 x sp 2 (same weights; the flash ring).

Serial run time ~90 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import _torch_sp_workers as sw
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu import optim as joptim
from distributed_pytorch_tpu.ops.losses import \
    cross_entropy_per_example as jax_ce
from distributed_pytorch_tpu.parallel import sequence as jseq
from distributed_pytorch_tpu.runtime import context as jcontext
from distributed_pytorch_tpu.runtime.jax_compat import shard_map

import distributed_pytorch_tpu as jdist

WORLD = 4
SHAPE = (2, 4, 64, 8)
VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)


def _data():
    rng = np.random.default_rng(21)
    return {n: rng.standard_normal(SHAPE).astype(np.float32)
            for n in ("q", "k", "v", "do")}


def _sp_lm_params():
    jm = jmodels.TransformerLM(**sw.SP_LM)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, 32, (4, 8)).astype(np.int64)
    return jm, params, toks


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    _, params, toks = _sp_lm_params()
    out = tmp_path_factory.mktemp("seq")
    launch_cpu_ranks(sw.seq_worker, WORLD, str(out), _data(), params, toks,
                     timeout_s=180)
    return torch.load(out / "seq.pt", weights_only=False)


def _np_perm(xs, pairs):
    out = [np.zeros_like(x) for x in xs]
    for s, d in pairs:
        out[d] = xs[s]
    return out


def test_point_to_point_values_and_gradients(run):
    xs = [np.arange(8.0, dtype=np.float32).reshape(2, 4) + 100 * r
          for r in range(WORLD)]
    ws = [np.arange(8.0, dtype=np.float32).reshape(2, 4) + 1000 * r
          for r in range(WORLD)]
    n = WORLD
    pairs = {"ring+1": [(i, (i + 1) % n) for i in range(n)],
             "ring-1": [(i, (i - 1) % n) for i in range(n)],
             "ring+2": [(i, (i + 2) % n) for i in range(n)],
             "line+1": [(i, i + 1) for i in range(n - 1)],
             "line-1": [(i, i - 1) for i in range(1, n)],
             "perm": [(0, 2), (2, 0), (1, 3)]}
    for name, pr in pairs.items():
        outs, grads = run["prim"][name]
        want = _np_perm(xs, pr)
        # the gradient of sum(w * out) is w sent back along the pairs
        want_g = _np_perm(ws, [(d, s) for s, d in pr])
        for r in range(n):
            np.testing.assert_array_equal(outs[r].numpy(), want[r],
                                          err_msg=f"{name} rank {r}")
            np.testing.assert_array_equal(grads[r].numpy(), want_g[r],
                                          err_msg=f"{name} grad rank {r}")


def test_all_to_all_and_its_gradient(run):
    outs, grads = run["prim"]["all_to_all"]
    xs = [np.arange(8.0, dtype=np.float32).reshape(2, 4) + 100 * r
          for r in range(WORLD)]
    # split the 4 columns over the ranks, concatenate the rows received
    for r in range(WORLD):
        want = np.concatenate([x[:, r:r + 1] for x in xs], axis=0)
        np.testing.assert_array_equal(outs[r].numpy(), want)
    ws = [np.arange(8.0, dtype=np.float32).reshape(8, 1) + 1000 * r
          for r in range(WORLD)]
    for r in range(WORLD):
        want = np.concatenate([w[2 * r:2 * r + 2] for w in ws], axis=1)
        np.testing.assert_array_equal(grads[r].numpy(), want)


def _jax_core(mesh, core, kw, q, k, v, do):
    spec = JP(None, None, "sp", None)

    def island(a, b_, c):
        if core == "dense":
            return jseq.ring_attention(a, b_, c, axis_name="sp", **kw)
        if core == "flash":
            return jseq.ring_flash_attention(a, b_, c, axis_name="sp",
                                             block_q=8, block_k=8, **kw)
        if core == "striped":
            return jseq.striped_ring_flash_attention(
                a, b_, c, axis_name="sp", block_q=8, block_k=8)
        return jseq.ulysses_attention(a, b_, c, axis_name="sp", block_q=8,
                                      block_k=8, **kw)
    f = shard_map(island, mesh=mesh, in_specs=(spec, spec, spec),
                  out_specs=spec, check_vma=False)
    o = jax.jit(f)(q, k, v)
    g = jax.jit(jax.grad(lambda a, b_, c: jnp.sum(f(a, b_, c) * do),
                         argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(t) for t in (o,) + tuple(g)]


@pytest.mark.parametrize("case", sw.CORES, ids=[c[0] for c in sw.CORES])
def test_cores_at_sp4_equal_jax(run, case):
    name, core, kw, h_kv = case
    data = {n: jnp.asarray(a) for n, a in _data().items()}
    data["k"], data["v"] = data["k"][:, :h_kv], data["v"][:, :h_kv]
    if core == "striped":
        data = {n: jseq.stripe_tokens(a, WORLD, axis=2)
                for n, a in data.items()}
    mesh = jcontext.init_mesh(dp=2, sp=WORLD)
    try:
        want = _jax_core(mesh, core, kw, data["q"], data["k"], data["v"],
                         data["do"])
    finally:
        jdist.cleanup()
    got = [np.concatenate([t.numpy() for t in parts], axis=2)
           for parts in run["cores"][name]]
    for label, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=f"{name} {label}",
                                   **(VALUE_TOL if label == "o"
                                      else GRAD_TOL))


def test_ulysses_refuses_heads_that_do_not_divide_the_axis(run):
    assert "divisible by the sp axis size 4" in run["ulysses_heads"]


@pytest.fixture(scope="module")
def jax_trajectory():
    """JAX's losses of ``SP_STEPS`` adamw steps on the whole batch (its
    own dp x tp x sp step equals this, ``tests/test_sequence_parallel
    .py``)."""
    jm, params, toks = _sp_lm_params()
    opt = joptim.adamw(sw.SP_LR)
    state = opt.init(params)
    x = jnp.asarray(toks)

    @jax.jit
    def step(p, st):
        val, g = jax.value_and_grad(
            lambda q: jnp.mean(jax_ce(jm.apply(q, x), x)))(p)
        p, st = opt.update(g, st, p)
        return val, p, st
    losses = []
    for _ in range(sw.SP_STEPS):
        val, params, state = step(params, state)
        losses.append(float(val))
    return losses


@pytest.mark.parametrize("core", ["dense", "flash"])
def test_dp2_sp2_from_inputs_step_equals_jax(run, jax_trajectory, core):
    want = jax_trajectory
    rec = run["mesh_step"][core]
    np.testing.assert_allclose(rec["losses"][0], want[0], rtol=2e-5)
    np.testing.assert_allclose(rec["losses"], want, **GRAD_TOL)
    assert rec["batch_placements"] == "(Shard(dim=0), Shard(dim=1))"


def test_dp4_sp1_rings_over_the_one_rank_sp_axis(run, jax_trajectory):
    np.testing.assert_allclose(run["dp4_sp1_loss"], jax_trajectory[0],
                               rtol=2e-5)


EXAMPLE = ["--steps", "4", "--seq-len", "32", "--batch-size", "4",
           "--dim", "32", "--n-layers", "1", "--n-heads", "4"]


def test_long_context_example_history_equals_jax(tmp_path):
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import train_long_context as jex
    args = EXAMPLE + ["--sp", "2"]
    want = []
    jex.main(args + ["--block-q", "16", "--block-k", "16"], quiet=True,
             history=want)
    jm = jmodels.TransformerLM(vocab=256, dim=32, n_layers=1, n_heads=4,
                               max_seq=32)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    launch_cpu_ranks(sw.example_worker, 2, str(tmp_path),
                     "train_long_context", args + ["--device", "cpu"],
                     params, timeout_s=180)
    rec = torch.load(tmp_path / "train_long_context.pt", weights_only=False)
    assert rec["mesh"] == {"dp": 1, "sp": 2}
    assert len(rec["history"]) == 3
    np.testing.assert_allclose(rec["history"], want, **GRAD_TOL)
