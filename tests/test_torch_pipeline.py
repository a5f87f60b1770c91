"""Pipeline parallelism of the port (``parallel/pipeline.py``) against
the JAX package.

- ``_build_1f1b_schedule``: the forward / backward tables and the ring
  depth equal JAX's for every (stages, microbatches) up to (5, 9).
- ``stack_layer_params`` of 8 transformer blocks loads the JAX
  package's stacked tree (``convert``) and reads it back unchanged; at
  one stage (no group) GPipe and 1F1B equal the blocks run in order.
- Four gloo ranks (``_torch_sp_workers.pipe_worker``): GPipe and 1F1B at
  pp 4 and at pp 2 (x dp 2), on 8 rows and on a ragged 7 (padded to 4
  microbatches of 2 with weight-0 rows), the stage parameters as each
  stage's slice or as a DTensor of the stack over pp: the loss and
  every stage's gradients against JAX's sequential
  ``jax.value_and_grad`` of the same blocks (``rtol 2e-4, atol 2e-5``,
  as ``tests/test_pipeline_moe.py``).

Serial run time ~40 s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sp_workers as sw
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu.nn.attention import TransformerBlock as JBlock
from distributed_pytorch_tpu.parallel import stack_layer_params as jstack
from distributed_pytorch_tpu.parallel.pipeline import \
    _build_1f1b_schedule as jax_schedule
from distributed_pytorch_tpu_torch import from_jax_params, to_jax_params
from distributed_pytorch_tpu_torch.nn.attention import TransformerBlock
from distributed_pytorch_tpu_torch.parallel.pipeline import (
    _build_1f1b_schedule, make_pipeline_train_fn, make_stage_fn,
    stack_layer_params)
from distributed_pytorch_tpu_torch.runtime import context

TOL = dict(rtol=2e-4, atol=2e-5)
N_LAYERS, DIM = 8, 16
# (pp, schedule, rows, stage params as a DTensor)
CASES = [(4, "1f1b", 8, False), (4, "gpipe", 8, False),
         (2, "1f1b", 8, False), (2, "gpipe", 8, False),
         (4, "1f1b", 7, True), (4, "gpipe", 7, False)]


@pytest.mark.parametrize("S", range(1, 6))
def test_1f1b_tables_equal_jax(S):
    for T in range(1, 10):
        got, want = _build_1f1b_schedule(S, T), jax_schedule(S, T)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


@functools.lru_cache(maxsize=None)
def _setup():
    block = JBlock(dim=DIM, n_heads=2, causal=True)
    keys = jax.random.split(jax.random.PRNGKey(0), N_LAYERS)
    layers = [block.init(k) for k in keys]
    stacked = jax.tree_util.tree_map(np.asarray, jstack(layers))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 4, DIM)).astype(np.float32)
    t = rng.standard_normal((8, 4, DIM)).astype(np.float32)
    return block, layers, stacked, x, t


@functools.lru_cache(maxsize=None)
def _jax_sequential(rows):
    """JAX's loss and gradients of the 8 blocks run in order on the
    first ``rows`` rows."""
    block, _, stacked, x, t = _setup()
    x, t = x[:rows], t[:rows]

    def loss(st):
        y = jnp.asarray(x)
        for i in range(N_LAYERS):
            y = block.apply(jax.tree_util.tree_map(lambda p: p[i], st), y)
        return jnp.mean(jnp.mean((y - t) ** 2, axis=(1, 2)))
    val, g = jax.jit(jax.value_and_grad(loss))(stacked)
    return float(val), g


def _port_stack(stacked):
    blocks = [TransformerBlock(DIM, 2, causal=True, device="cpu")
              for _ in range(N_LAYERS)]
    return from_jax_params(stacked, stack_layer_params(blocks))


def _mse(y, tgt):
    return ((y - tgt) ** 2).mean(dim=tuple(range(1, y.dim())))


def test_stack_round_trips_through_convert():
    _, _, stacked, _, _ = _setup()
    stack = _port_stack(stacked)
    assert stack.n_stacked == N_LAYERS
    assert tuple(stack.attn.qkv.weight.shape) == (N_LAYERS, 3 * DIM, DIM)
    for a, b in zip(jax.tree_util.tree_leaves(to_jax_params(stack)),
                    jax.tree_util.tree_leaves(stacked)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
@pytest.mark.parametrize("rows", [8, 7])
def test_one_stage_equals_the_blocks_in_order(schedule, rows):
    _, _, stacked, x, t = _setup()
    want_loss, want = _jax_sequential(rows)
    stack = _port_stack(stacked)
    fn = make_pipeline_train_fn(context.get_mesh(), make_stage_fn(stack),
                                _mse, 4, schedule=schedule)
    loss, grads = fn(dict(stack.named_parameters()),
                     torch.from_numpy(x[:rows]), torch.from_numpy(t[:rows]))
    assert float(loss) == pytest.approx(want_loss, rel=2e-5)
    for p in stack.parameters():
        p.grad = None
    for n, p in stack.named_parameters():
        p.grad = grads[n]
    for (path, g), w in zip(
            jax.tree_util.tree_leaves_with_path(
                to_jax_params(stack, grads=True)),
            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **TOL)


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    _, _, stacked, x, t = _setup()
    out = tmp_path_factory.mktemp("pipe")
    launch_cpu_ranks(sw.pipe_worker, 4, str(out), stacked, x, t, CASES,
                     timeout_s=180)
    return torch.load(out / "pipe.pt", weights_only=False)


@pytest.mark.parametrize("case", CASES,
                         ids=[f"pp{c[0]}-{c[1]}-b{c[2]}"
                              + ("-dtensor" if c[3] else "")
                              for c in CASES])
def test_pipelined_step_equals_jax(pipe_run, case):
    pp, schedule, rows, as_dtensor = case
    _, _, stacked, _, _ = _setup()
    want_loss, want = _jax_sequential(rows)
    rec = pipe_run[case]
    assert rec["loss"] == pytest.approx(want_loss, rel=2e-5)
    assert rec["dtensor_grads"] == as_dtensor
    stack = _port_stack(stacked)
    for n, p in stack.named_parameters():
        p.grad = torch.from_numpy(rec["grads"][n])
    for (path, g), w in zip(
            jax.tree_util.tree_leaves_with_path(
                to_jax_params(stack, grads=True)),
            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **TOL)


def test_stacked_specs_map_onto_placements():
    """A ``P("pp", ...)`` spec of the stacked tree shards the leading
    layer axis; a Linear W's other axes swap as in an unstacked layer;
    the sequence layout ``(dp, tp, sp, None)`` maps dimension for
    dimension."""
    from distributed_pytorch_tpu_torch.convert import (ParamSlot,
                                                       jax_param_slots,
                                                       spec_placements)
    from distributed_pytorch_tpu_torch.parallel.tensor import P
    _, _, stacked, _, _ = _setup()
    slots = jax_param_slots(_port_stack(stacked))
    axes = ("pp", "tp")
    assert str(spec_placements(P("pp", None, "tp"),
                               slots["attn"]["qkv"]["w"], axes)) \
        == "(Shard(dim=0), Shard(dim=1))"
    assert str(spec_placements(P("pp", "tp", None),
                               slots["fc2"]["w"], axes)) \
        == "(Shard(dim=0), Shard(dim=2))"
    assert str(spec_placements(P("pp"), slots["ln1"]["scale"], axes)) \
        == "(Shard(dim=0), Replicate())"
    assert str(spec_placements(P("dp", "tp", "sp", None),
                               ParamSlot(0, False, None),
                               ("dp", "tp", "sp"))) \
        == "(Shard(dim=0), Shard(dim=1), Shard(dim=2))"
