"""Rank workers and elastic targets of the port's fault-layer tests
(``tests/test_torch_faults.py``, ``test_torch_elastic.py``,
``test_torch_multihost.py``). They import the port only, so the spawned
processes never load JAX; each records what it saw as JSON under
``out_dir``."""

import json
import os
import time

import numpy as np

#: per-op deadline of the chaos launches (ms)
TIMEOUT_MS = 1500


def _dump(out_dir, name, rec):
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f)


def kill_worker(rank, world, out_dir):
    """Rank 1 is killed entering its first all-reduce (``DPX_FAULT`` set
    by the parent): rank 0 records the typed error it raises, and how
    long after entering the op, then re-raises for the supervisor."""
    from distributed_pytorch_tpu_torch.runtime import context
    from distributed_pytorch_tpu_torch.runtime.native import CommError

    context.init_process_group(rank, world, backend="host")
    comm = context.get_host_comm()
    comm.barrier()
    t0 = time.monotonic()
    try:
        comm.allreduce(np.ones(4096, np.float32))
    except CommError as e:
        from distributed_pytorch_tpu_torch.runtime import env
        _dump(out_dir, f"rank{rank}.json",
              {"kind": type(e).__name__, "op": e.op, "peer": e.peer,
               "elapsed_s": time.monotonic() - t0,
               "tag": env.raw("DPX_WORKER_TAG")})
        raise


# -- elastic: a 2-rank gloo worker that checkpoints every step ------------

STEPS = 6


def _model():
    import torch

    from distributed_pytorch_tpu_torch.models import TransformerLM
    return TransformerLM(vocab=32, dim=16, n_layers=1, n_heads=2, max_seq=8,
                         device="cpu",
                         generator=torch.Generator().manual_seed(0))


def _batch(step, rank):
    import torch
    toks = np.random.default_rng(1000 * step + rank).integers(0, 32, (4, 9))
    return (torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:]))


def _loss(model, batch):
    from distributed_pytorch_tpu_torch.ops.losses import cross_entropy
    x, y = batch
    return cross_entropy(model(x), y), {}


def _train(model, opt, state, start, steps, rank, ckpt_dir=None,
           hooks=False):
    import torch

    from distributed_pytorch_tpu_torch import all_reduce
    from distributed_pytorch_tpu_torch.parallel import make_train_step
    from distributed_pytorch_tpu_torch.runtime import faults
    from distributed_pytorch_tpu_torch.utils.checkpoint import \
        save_checkpoint
    step_fn = make_train_step(_loss, opt)
    losses = []
    for step in range(start, steps):
        if hooks:
            faults.on_step(step, rank=rank)
        out = step_fn(model, state, _batch(step, rank))
        state = out.opt_state
        losses.append(all_reduce(out.loss.detach().clone(), "avg").item())
        if ckpt_dir is not None:
            save_checkpoint(ckpt_dir, step, model, state)
    params = [p.detach().numpy().tolist() for p in model.parameters()]
    return losses, params, torch


def elastic_rank_worker(rank, world, ckpt_dir, out_dir):
    """Train :data:`STEPS` steps from the latest checkpoint (none: from
    the seed), saving one after every step, with the ``on_step`` fault
    hook armed; on the run that finishes, also train the uninterrupted
    reference from the seed, with no checkpoint and no hook."""
    from distributed_pytorch_tpu_torch import init_process_group, optim
    from distributed_pytorch_tpu_torch.runtime.elastic import elastic_attempt
    from distributed_pytorch_tpu_torch.utils.checkpoint import (
        latest_step, restore_checkpoint)

    init_process_group(rank, world)
    model, opt = _model(), optim.adamw(1e-2)
    state = opt.init(model.parameters())
    start = 0
    if latest_step(ckpt_dir) is not None:
        ck = restore_checkpoint(ckpt_dir, like_params=model,
                                like_opt_state=state)
        state, start = ck.opt_state, ck.step + 1
    losses, params, _ = _train(model, opt, state, start, STEPS, rank,
                               ckpt_dir=ckpt_dir, hooks=True)
    ref_model = _model()
    ref_losses, ref_params, _ = _train(
        ref_model, opt, opt.init(ref_model.parameters()), 0, STEPS, rank)
    _dump(out_dir, f"rank{rank}_attempt{elastic_attempt()}.json",
          {"start": start, "losses": losses, "params": params,
           "ref_losses": ref_losses, "ref_params": ref_params})


def elastic_target(ckpt_dir, out_dir):
    """The supervised child of ``elastic_run``: one 2-rank gloo launch
    (a rank's death fails it, and the child exits non-zero)."""
    from distributed_pytorch_tpu_torch.runtime.multiprocess import \
        launch_multiprocess
    launch_multiprocess(elastic_rank_worker, 2, ckpt_dir, out_dir,
                        device="cpu", timeout_s=90)


def exits_with(code):
    """An elastic target that always dies with ``code``."""
    os._exit(code)


def sleeps_long(pid_file):
    """An elastic target that records its pid and sleeps."""
    with open(pid_file, "w") as f:
        f.write(str(os.getpid()))
    time.sleep(120)


# -- multihost: two CPU processes as two one-device hosts ------------------

def multihost_worker(rank, world, out_dir):
    from distributed_pytorch_tpu_torch.runtime import env, multihost
    multihost.initialize(
        f"{env.get('DPX_MASTER_ADDR')}:{env.get('DPX_MASTER_PORT')}",
        world, rank)
    multihost.initialize(                 # idempotent
        f"{env.get('DPX_MASTER_ADDR')}:{env.get('DPX_MASTER_PORT')}",
        world, rank)
    mesh = multihost.init_hybrid_mesh(ici=[("tp", 1)], dcn=[("dp", 2)])
    try:
        multihost.init_hybrid_mesh(ici=[("tp", 2)], dcn=[("dp", 1)])
        wrong = None
    except ValueError as e:
        wrong = str(e)
    gathered = multihost.process_allgather(np.array([rank, 10 * rank]))
    bcast = multihost.broadcast_from_primary(np.array([7 + rank] * 3))
    _dump(out_dir, f"rank{rank}.json", {
        "num_hosts": multihost.num_hosts(),
        "host_index": multihost.host_index(),
        "is_primary_host": multihost.is_primary_host(),
        "slice": list(multihost.local_device_slice()),
        "mesh_shape": list(mesh.mesh.shape),
        "mesh_names": list(mesh.mesh_dim_names),
        "mesh_ranks": mesh.mesh.tolist(),
        "my_coordinate": list(mesh.get_coordinate()),
        "wrong_slices": wrong,
        "gathered": gathered.tolist(), "bcast": bcast.tolist()})
