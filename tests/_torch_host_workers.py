"""Rank workers of the host-comm tests (``test_torch_host_comm.py``,
``test_torch_grad_wire.py``), spawned by ``launch_multiprocess``.

They import the port and numpy only (the JAX package only where a
worker holds the two packages' rings to each other), so a rank starts
without loading JAX. Each writes what it saw to
``<out_dir>/rank<r>.json``.
"""

import hashlib
import json
import os
import time

import numpy as np

RING_N = 70_000          # the quantized ring's parity size
BIG_N = 300_000          # crosses socket-buffer sizes (deadlock regression)


def rank_input(rank: int, n: int = RING_N) -> np.ndarray:
    """Rank ``rank``'s seeded ring input."""
    return (np.random.default_rng(100 + rank).standard_normal(n) * 2
            ).astype(np.float32)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _dump(out_dir, rank, rec):
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def collectives_worker(rank, world, out_dir):
    """Every collective of the API over the host group, then the
    quantized rings (flat, the two legs, hierarchical with L = 2) on the
    seeded inputs."""
    import torch

    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.comm.hier import hier_ring
    from distributed_pytorch_tpu_torch.runtime import context

    dist.init_process_group(rank, world)
    rec = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend(), "primary": dist.is_primary(),
           "device": str(dist.get_device())}
    x = torch.full((5,), float(rank + 1))
    rec["sum"] = dist.all_reduce(x.clone(), "sum").tolist()
    rec["avg"] = dist.all_reduce(x.clone(), "avg").tolist()
    big = dist.all_reduce(torch.full((BIG_N,), float(rank + 1)), "sum")
    rec["big"] = [float(big[0]), float(big[-1]), float(big.min())]
    red = torch.full((3,), float(rank + 1))
    rec["reduce_is_input"] = dist.reduce(red) is red
    rec["reduce"] = red.tolist()
    rec["gather"] = [t.tolist() for t in
                     dist.gather(torch.full((2,), float(rank)))]
    rec["all_gather"] = dist.all_gather(torch.full((2,), float(rank))
                                        ).tolist()
    rec["max"] = dist.all_reduce(torch.full((2,), float(rank)), "max"
                                 ).tolist()
    ir = dist.reduce(torch.full((2,), rank + 1, dtype=torch.int64))
    rec["int_reduce"], rec["int_reduce_dtype"] = ir.tolist(), str(ir.dtype)
    iq = dist.all_reduce(torch.full((3,), rank + 1, dtype=torch.int64),
                         "sum", wire="quant")
    rec["int_quant"], rec["int_quant_dtype"] = iq.tolist(), str(iq.dtype)
    bf = dist.all_reduce(torch.full((4,), float(rank + 1),
                                    dtype=torch.bfloat16), "sum")
    rec["bf16_sum"], rec["bf16_dtype"] = bf.float().tolist(), str(bf.dtype)
    rec["bcast"] = dist.broadcast(torch.full((4,), float(rank)), src=2
                                  ).tolist()
    p = torch.full((2,), float(rank))
    rec["sync"] = dist.sync_params([p])[0].tolist()
    for wire in ("quant", "q4", "adaptive"):
        mine = torch.from_numpy(rank_input(rank, 3000))
        rec[f"sync_{wire}"] = sha(dist.sync_params([mine], wire=wire)[0]
                                  .numpy())
        q = dist.all_reduce(torch.from_numpy(rank_input(rank)), "sum",
                            wire=wire)
        rec[f"allreduce_{wire}"] = sha(q.numpy())
    dist.barrier()
    dist.wait_for_everyone()

    comm = context.get_host_comm()
    comm.stats.reset()
    for bits in (8, 4):
        buf = rank_input(rank)
        comm.allreduce_quant(buf, bits)
        rec[f"ring_q{bits}"] = sha(buf)
    buf = rank_input(rank)
    comm.reduce_scatter_q8(buf)
    lo, cnt = comm.owned_span(buf.size)
    rec["owned"] = [lo, cnt]
    rec["rs_owned"] = sha(buf[lo:lo + cnt])
    comm.allgather_q8(buf)
    rec["rs_ag"] = sha(buf)
    exact = rank_input(rank)
    comm.allreduce(exact)
    rec["ring_f32"] = sha(exact)
    rec["stats"] = comm.stats.summary()
    ring = hier_ring(comm, 2)
    buf = rank_input(rank)
    ring.allreduce(buf, bits=8)
    rec["hier_q8"] = sha(buf)
    rec["slow_hop_bytes"] = ring.slow_hop_bytes(RING_N)
    rec["hier_stats"] = {k: v["bytes"] for k, v in
                         comm.stats.summary().items()
                         if k.startswith("hier")}
    _dump(out_dir, rank, rec)
    dist.cleanup()


def two_packages_worker(rank, world, out_dir, jax_port):
    """The port's HostComm and the JAX package's, on the same inputs, in
    the same rank process (the JAX group on ports of its own)."""
    from distributed_pytorch_tpu_torch.runtime import context
    from distributed_pytorch_tpu_torch.runtime import env

    context.init_process_group(rank, world, backend="host")
    mine = context.get_host_comm()
    from distributed_pytorch_tpu.runtime.native import HostComm as JaxComm
    ref = JaxComm("127.0.0.1", jax_port, rank, world)
    rec = {}
    for label, comm in (("port", mine), ("jax", ref)):
        out = {}
        for bits in (8, 4):
            buf = rank_input(rank)
            comm.allreduce_quant(buf, bits)
            out[f"q{bits}"] = sha(buf)
            buf = rank_input(rank)
            comm.reduce_scatter_quant(buf, bits)
            out[f"rs{bits}"] = sha(buf)
            comm.allgather_quant(buf, bits)
            out[f"ag{bits}"] = sha(buf)
        buf = rank_input(rank)
        comm.allreduce(buf)
        out["f32"] = sha(buf)
        buf = rank_input(rank).astype(np.float64)
        comm.allreduce(buf, op="max")
        out["f64_max"] = sha(buf)
        out["bytes"] = {op: d["bytes"] for op, d in
                        comm.stats.summary().items()}
        rec[label] = out
    rec["timeout_ms"] = int(env.get("DPX_COMM_TIMEOUT_MS"))
    ref.close()
    _dump(out_dir, rank, rec)
    context.destroy_process_group()


def killed_peer_worker(rank, world, out_dir):
    """Rank 1 dies without a word (SIGKILL) while rank 0 waits in an
    all-reduce: rank 0 raises the typed CommPeerDied naming rank 1."""
    import signal

    from distributed_pytorch_tpu_torch.runtime import context

    context.init_process_group(rank, world, backend="host")
    comm = context.get_host_comm()
    comm.barrier()
    if rank == 1:
        time.sleep(0.3)
        os.kill(os.getpid(), signal.SIGKILL)
    comm.allreduce(np.ones(BIG_N, np.float32))


def transport_worker(rank, world, out_dir, frame_bytes, die):
    """``HostCommTransport`` between two processes: rank 1 (prefill)
    sends two frames, rank 0 (decode) receives them. With ``die``, the
    prefill rank exits after the length header of its second frame and
    the decode rank's receive must fail typed."""
    from distributed_pytorch_tpu_torch.runtime import context
    from distributed_pytorch_tpu_torch.serve.disagg import (
        HostCommTransport, TransportSevered)

    context.init_process_group(rank, world, backend="host")
    comm = context.get_host_comm()
    tr = HostCommTransport(comm, src=1)
    frames = [np.random.default_rng(i).integers(0, 256, frame_bytes,
                                                dtype=np.uint8).tobytes()
              for i in range(2)]
    rec = {}
    if rank == 1:
        tr.send(frames[0], kv_bytes=len(frames[0]))
        if die:
            comm.broadcast(np.array([len(frames[1])], np.int64), src=1)
            os._exit(0)
        tr.send(frames[1], kv_bytes=len(frames[1]))
        rec["sent"] = tr.frames_sent
        rec["booked"] = tr.stats.summary()["handoff_send"]["bytes"]
    else:
        rec["frame0"] = tr.recv() == frames[0]
        try:
            rec["frame1"] = tr.recv() == frames[1]
        except TransportSevered as e:
            rec["severed"] = True
            rec["cause"] = type(e.__cause__).__name__
            rec["peer"] = getattr(e.__cause__, "peer", None)
            rec["op"] = getattr(e.__cause__, "op", None)
        rec["received"] = tr.frames_recv
    _dump(out_dir, rank, rec)
    if not die:
        context.destroy_process_group()


def clean_exit_worker(rank, world, out_dir):
    """Each rank leaves through ``SystemExit`` after a barrier: rank 0
    with ``sys.exit()``, rank 1 with ``sys.exit(0)``."""
    import sys

    import distributed_pytorch_tpu_torch as dist

    dist.init_process_group(rank, world)
    dist.barrier()
    _dump(out_dir, rank, {"rank": rank})
    sys.exit(None if rank == 0 else 0)


# -- the gradient wire of make_train_step ---------------------------------

MLP = dict(d_in=16, d_hid=32, d_out=4, batch=8)
TRAIN_STEPS = 4
TRAIN_LR = 1e-2
# (label, grad_reduce, weight_update, overlap, optimizer)
TRAIN_ARMS = [("mean", "mean", "replicated", False, "adamw"),
              ("quant", "quant", "replicated", False, "adamw"),
              ("int8", "int8", "replicated", False, "adamw"),
              ("q4", "q4", "replicated", False, "adamw"),
              ("adaptive", "adaptive", "replicated", False, "adamw"),
              ("overlap_mean", "mean", "replicated", True, "adamw"),
              ("overlap_quant", "quant", "replicated", True, "adamw"),
              ("sharded_mean", "mean", "sharded", False, "adamw"),
              ("sharded_quant", "quant", "sharded", False, "adamw"),
              # sgd moves by the gradient's size (adam by its sign at
              # first), so a mean that is not divided by the world shows
              ("quant_sgd", "quant", "replicated", False, "sgd")]
ARMS = {arm[0]: arm[1:] for arm in TRAIN_ARMS}
# the arms the JAX package's host door runs too
JAX_ARMS = ("mean", "quant", "q4", "adaptive", "overlap_quant", "quant_sgd")


def mlp_init(seed: int = 0) -> dict:
    """The seeded MLP weights, (in, out) layouts, in JAX tree order."""
    rng = np.random.default_rng(seed)
    m = MLP
    return {"b1": (rng.standard_normal(m["d_hid"]) * 0.1).astype(np.float32),
            "b2": np.zeros(m["d_out"], np.float32),
            "w1": (rng.standard_normal((m["d_in"], m["d_hid"]))
                   / np.sqrt(m["d_in"])).astype(np.float32),
            "w2": (rng.standard_normal((m["d_hid"], m["d_out"]))
                   / np.sqrt(m["d_hid"])).astype(np.float32)}


def mlp_batch(rank: int, step: int):
    """Rank ``rank``'s local batch of step ``step``."""
    rng = np.random.default_rng(1000 * rank + step)
    m = MLP
    x = rng.standard_normal((m["batch"], m["d_in"])).astype(np.float32)
    y = rng.standard_normal((m["batch"], m["d_out"])).astype(np.float32)
    return x, y


def port_mlp(seed: int = 0):
    """The MLP as a torch module whose parameters are in JAX tree
    order, so both packages fill one bucket alike."""
    import torch

    class Mlp(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in mlp_init(seed).items():
                self.register_parameter(
                    k, torch.nn.Parameter(torch.from_numpy(v.copy())))

        def forward(self, x):
            h = torch.relu(x @ self.w1 + self.b1)
            return h @ self.w2 + self.b2

    return Mlp()


def port_mlp_loss(model, batch):
    x, y = batch
    return ((model(x) - y) ** 2).mean(), {}


def run_port_arm(grad_reduce, weight_update, overlap, rank,
                 on_bucket_ready=None, optimizer="adamw"):
    """TRAIN_STEPS steps of one arm: the losses, the final flat params,
    the step, this rank's first-step gradients (quantized arms) and the
    flat params after the first step."""
    import torch

    from distributed_pytorch_tpu_torch import optim
    from distributed_pytorch_tpu_torch.parallel import make_train_step

    model = port_mlp()
    opt = getattr(optim, optimizer)(TRAIN_LR)
    step = make_train_step(port_mlp_loss, opt, grad_reduce=grad_reduce,
                           weight_update=weight_update, overlap=overlap,
                           comm_buckets=2, on_bucket_ready=on_bucket_ready)
    state = (step.init_opt_state(model.parameters())
             if hasattr(step, "init_opt_state")
             else opt.init(model.parameters()))
    losses, grads0 = [], None
    for t in range(TRAIN_STEPS):
        x, y = mlp_batch(rank, t)
        batch = (torch.from_numpy(x), torch.from_numpy(y))
        if t == 0 and grad_reduce != "mean":
            from distributed_pytorch_tpu_torch.parallel.data_parallel \
                import forward_backward
            _, gs, _, _ = forward_backward(port_mlp_loss, "off")(model,
                                                                  batch)
            grads0 = [g.detach().clone() for g in gs]
        out = step(model, state, batch)
        state = out.opt_state
        losses.append(float(out.loss[0]))
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()]).numpy()
        if t == 0:
            step1 = flat
    return losses, flat, step, grads0, step1


def train_worker(rank, world, out_dir):
    """Every arm of TRAIN_ARMS at this world over the group the launcher
    made (host or gloo)."""
    import torch

    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.runtime import context

    if world > 1:
        dist.init_process_group(rank, world)
    comm = context.get_host_comm()
    rec = {"backend": dist.get_backend()}
    for label, gr, wu, ov, optimizer in TRAIN_ARMS:
        seen = []
        if comm is not None:
            comm.stats.reset()
        losses, flat, step, grads0, step1 = run_port_arm(
            gr, wu, ov, rank,
            on_bucket_ready=lambda b, n, nb: seen.append([b, n, nb]),
            optimizer=optimizer)
        np.save(os.path.join(out_dir, f"{label}_rank{rank}.npy"), flat)
        np.save(os.path.join(out_dir, f"{label}_step1_rank{rank}.npy"),
                step1)
        arm = {"losses": losses, "params": sha(flat), "step1": sha(step1),
               "buckets_seen": seen}
        if grads0 is not None:
            np.save(os.path.join(out_dir, f"{label}_grads0_rank{rank}.npy"),
                    torch.cat([g.reshape(-1) for g in grads0]).numpy())
        if comm is not None:
            arm["stats"] = comm.stats.summary()
        chooser = getattr(step, "width_chooser", None)
        if chooser is not None:
            arm["widths"] = list(chooser.widths)
        rec[label] = arm
    _dump(out_dir, rank, rec)
    if world > 1:
        dist.cleanup()


def jax_train_worker(rank, world, out_dir):
    """The JAX package's host door on the same MLP, weights and batches,
    in every arm of JAX_ARMS: the losses, the params after the first
    step and the final params, in the port's order."""
    import jax
    import jax.numpy as jnp

    import distributed_pytorch_tpu as jdist
    from distributed_pytorch_tpu import optim as joptim
    from distributed_pytorch_tpu.parallel import make_train_step

    jdist.init_process_group(rank, world)

    def loss_fn(params, batch):
        x, y = batch
        h = jax.nn.relu(x @ params["w1"] + params["b1"])
        return jnp.mean((h @ params["w2"] + params["b2"] - y) ** 2), {}

    def flat(params):
        return np.concatenate([np.asarray(params[k]).ravel()
                               for k in ("b1", "b2", "w1", "w2")])

    rec = {}
    for label in JAX_ARMS:
        gr, _, overlap, optimizer = ARMS[label]
        params = {k: jnp.asarray(v) for k, v in mlp_init().items()}
        opt = getattr(joptim, optimizer)(TRAIN_LR)
        step = make_train_step(loss_fn, opt, grad_reduce=gr,
                               overlap=overlap, comm_buckets=2)
        state = (step.init_opt_state(params)
                 if hasattr(step, "init_opt_state") else opt.init(params))
        losses = []
        for t in range(TRAIN_STEPS):
            out = step(params, state, tuple(jnp.asarray(a)
                                            for a in mlp_batch(rank, t)))
            params, state = out.params, out.opt_state
            losses.append(float(np.asarray(out.loss)[0]))
            if t == 0:
                np.save(os.path.join(out_dir, f"jax_{label}_step1_rank{rank}"
                                     ".npy"), flat(params))
        np.save(os.path.join(out_dir, f"jax_{label}_rank{rank}.npy"),
                flat(params))
        rec[label] = losses
    _dump(out_dir, rank, rec)
    jdist.cleanup()


PRIM_N = 4 * 1024 * 2        # a multiple of world * block at world 2


def prim_input(rank: int, n: int = PRIM_N) -> np.ndarray:
    return (np.random.default_rng(500 + rank).standard_normal(n) * 3
            ).astype(np.float32)


def primitives_worker(rank, world, out_dir):
    """Every primitive of ``comm/primitives.py`` on seeded per-rank
    inputs over the launcher's group; the outputs to
    ``<out_dir>/prim_rank<r>.npz``."""
    import torch

    import distributed_pytorch_tpu_torch as dist
    from distributed_pytorch_tpu_torch.comm import primitives as prim

    dist.init_process_group(rank, world)
    x = torch.from_numpy(prim_input(rank))
    m = x.reshape(4, -1)
    out = {"psum": prim.psum(x), "pmean": prim.pmean(x),
           "pmax": prim.pmax(x), "pmin": prim.pmin(x),
           "all_gather": prim.all_gather(m, axis=1),
           "all_gather_tiled": prim.all_gather(m, axis=1, tiled=True),
           "reduce_scatter": prim.reduce_scatter(m, scatter_axis=1),
           "all_to_all": prim.all_to_all(m, 0, 1),
           "quantized_pmean": prim.quantized_pmean(x),
           "quantized_pmean_q4": prim.quantized_pmean(x[:5000], bits=4),
           "quantized_reduce_scatter": prim.quantized_reduce_scatter(x),
           "quantized_all_gather": prim.quantized_all_gather(x[:2048])}
    assert torch.equal(x, torch.from_numpy(prim_input(rank)))  # untouched
    np.savez(os.path.join(out_dir, f"prim_rank{rank}.npz"),
             **{k: v.numpy() for k, v in out.items()})
    dist.cleanup()
