"""Rank workers of ``test_torch_ckpt_sharded.py``, spawned by
``launch_multiprocess`` over gloo CPU ranks.

They import the port, torch and numpy only: the weights (a JAX param
tree of numpy arrays) and the batches come in as arguments. Rank 0
writes what the ranks saw to ``<out_dir>/<name>.pt``.
"""

import os

import numpy as np
import torch

import _torch_fsdp_workers as fw


def _numpy_tree(tree):
    """A gathered JAX-layout tree (``fsdp.gather_state``) as numpy
    float32 / int arrays, NamedTuples as dicts of their fields."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _numpy_tree(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def _per_rank(values):
    """Every rank's list of ints, on every rank."""
    from distributed_pytorch_tpu_torch.comm.collectives import all_gather
    t = torch.tensor(values, dtype=torch.int64)
    return all_gather(t).tolist()


def zero3_restore_worker(rank, world, out_dir, ck_dir, params_np):
    """A ZeRO-3 model and state at ``world`` restored in place from a
    format-2 checkpoint of any layout; records the gathered state and
    each rank's read bytes and members."""
    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.ckpt import ReadStats, restore_sharded
    from distributed_pytorch_tpu_torch.parallel import fsdp
    from distributed_pytorch_tpu_torch.runtime import context

    dist.init_process_group(rank, world)
    mesh = context.init_mesh(dp=world)
    model = fw.build(params_np)
    opt = fw.optimizer("adamw")
    specs = fsdp.fsdp_param_specs(model, world)
    model, state = fsdp.shard_model_and_opt(
        model, opt.init(model.parameters()), mesh, specs)
    stats = ReadStats()
    ck = restore_sharded(ck_dir, like_params=model, like_opt_state=state,
                         stats=stats, rank=rank)
    placements = sorted({str(tuple(p.placements)) for p in model.parameters()
                         if hasattr(p, "placements")})
    p_tree, o_tree = fsdp.gather_state(model, ck.opt_state)
    reads = _per_rank([stats.bytes, stats.members])
    if rank == 0:
        torch.save({"params": _numpy_tree(p_tree),
                    "opt_state": _numpy_tree(o_tree), "step": ck.step,
                    "reads": reads, "placements": placements},
                   os.path.join(out_dir, "restored.pt"))
    dist.cleanup()


def save_worker(rank, world, out_dir, ck_dir, params_np, batches, tp):
    """Two ZeRO-3 adamw steps (over ``dp = world``, or ``dp 2 x tp 2``
    with ``tensor_parallel_lm`` under ``tp``), then a format-2 save of the
    model and its state (every rank its own shards); records the
    gathered state and each rank's written and moved bytes."""
    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.ckpt import CheckpointManager
    from distributed_pytorch_tpu_torch.parallel import fsdp, tensor
    from distributed_pytorch_tpu_torch.runtime import context

    dist.init_process_group(rank, world)
    model = fw.build(params_np)
    if tp:
        mesh = context.init_mesh(dp=2, tp=world // 2)
        model = tensor.tensor_parallel_lm(model, mesh)
        specs = fsdp.fsdp_param_specs(
            model, 2, base_specs=tensor.transformer_lm_param_specs(model))
        axes = {"dp": 2, "tp": world // 2}
        dp_index, n_dp = mesh["dp"].get_local_rank(), 2
    else:
        mesh = context.init_mesh(dp=world)
        specs = fsdp.fsdp_param_specs(model, world)
        axes = {"dp": world}
        dp_index, n_dp = rank, world
    opt = fw.optimizer("adamw")
    step = fsdp.make_fsdp_train_step(fw.lm_loss, opt, mesh, specs)
    state = opt.init(model.parameters())
    for batch in batches:
        state = step(model, state, fw.local(batch, dp_index, n_dp)).opt_state
    with CheckpointManager(ck_dir, sharded=True, param_specs=specs,
                           axis_sizes=axes, async_save=True) as mgr:
        mgr.save(len(batches), model, state, extra={"epoch": 0})
    saved = mgr.saves[-1]
    p_tree, o_tree = fsdp.gather_state(model, state)
    written = _per_rank([saved["bytes"], saved["shards"],
                         saved["moved_bytes"]])
    if rank == 0:
        torch.save({"params": _numpy_tree(p_tree),
                    "opt_state": _numpy_tree(o_tree), "written": written,
                    "specs": specs, "axes": axes},
                   os.path.join(out_dir, "saved.pt"))
    dist.cleanup()
