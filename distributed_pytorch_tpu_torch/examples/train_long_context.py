"""Long-context LM training with sequence parallelism.

Counterpart of the JAX package's ``examples/train_long_context.py``,
with its arguments plus ``--device`` and ``--nprocs``. The sequence
axis is sharded over the ``sp`` axis of a ``dp x sp`` mesh of the ranks:
each rank holds S/sp of every example of its dp share, and attention
runs as the island of ``parallel.spmd.make_gspmd_ring_attn_fn`` (the
flash ring, the striped ring or Ulysses; ``--window`` for sliding-window
attention); everything else is DTensor propagation from the parameter
and batch layouts (``make_spmd_train_step``). At one rank there is no
mesh: the model and batch are plain tensors and the ring has one hop.

The data are the JAX example's: one seeded (B, S + 1) byte batch
(``numpy.random.default_rng(0)``), trained on every step; with
``--sp-core striped`` the tokens, targets and position ids are striped
once at the data level. The loss of every step after the first goes
to ``history``, as in the JAX example.

Run (one rank per visible card; ``--device cpu --nprocs 2`` for two CPU
ranks over gloo)::

    python -m distributed_pytorch_tpu_torch.examples.train_long_context --steps 20 --seq-len 2048
    python -m distributed_pytorch_tpu_torch.examples.train_long_context --device cpu --nprocs 2 --sp 2 --steps 6 --seq-len 128 --dim 32 --n-layers 1 --n-heads 4
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

import distributed_pytorch_tpu_torch as dist
from distributed_pytorch_tpu_torch.examples.min_ddp import rank_device
from distributed_pytorch_tpu_torch.models import TransformerLM
from distributed_pytorch_tpu_torch.ops.losses import \
    cross_entropy_per_example
from distributed_pytorch_tpu_torch.optim import adamw
from distributed_pytorch_tpu_torch.parallel import (make_spmd_train_step,
                                                    shard_batch_spec)
from distributed_pytorch_tpu_torch.parallel.sequence import stripe_tokens
from distributed_pytorch_tpu_torch.parallel.spmd import \
    make_gspmd_ring_attn_fn
from distributed_pytorch_tpu_torch.parallel.tensor import (
    P, shard_params, transformer_lm_param_specs)
from distributed_pytorch_tpu_torch.runtime import context
from distributed_pytorch_tpu_torch.runtime.device import default_generator
from distributed_pytorch_tpu_torch.utils import MetricsLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Sequence-parallel long-context LM training")
    p.add_argument("--steps", default=20, type=int)
    p.add_argument("--seq-len", default=2048, type=int)
    p.add_argument("--batch-size", default=2, type=int,
                   help="GLOBAL batch (sharded over the dp axis).")
    p.add_argument("--sp", default=0, type=int,
                   help="Ring size (sequence shards); 0 = all ranks. The "
                        "rest of the ranks become the dp axis.")
    p.add_argument("--dim", default=256, type=int)
    p.add_argument("--n-layers", default=4, type=int)
    p.add_argument("--n-heads", default=8, type=int)
    p.add_argument("--lr", default=3e-4, type=float)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--block-q", default=128, type=int,
                   help="The JAX kernel's tile; the CUDA kernels fix "
                        "their own (accepted, unused).")
    p.add_argument("--block-k", default=128, type=int,
                   help="As --block-q.")
    p.add_argument("--sp-core", default="flash",
                   choices=("flash", "striped", "ulysses"),
                   help="'flash' = contiguous ring with the flash kernel "
                        "per hop; 'striped' = load-balanced causal ring "
                        "(tokens/targets/positions striped once at the "
                        "data level); 'ulysses' = all-to-all heads<->"
                        "sequence around a full-sequence kernel (heads "
                        "must divide sp).")
    p.add_argument("--striped", dest="sp_core", action="store_const",
                   const="striped", help="alias for --sp-core striped")
    p.add_argument("--window", default=None, type=int,
                   help="Sliding-window attention width (flash and "
                        "ulysses cores): ring hops past the window never "
                        "run.")
    p.add_argument("--log", default=None, type=str)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="Run on the CPU, or on the card (default).")
    p.add_argument("--nprocs", default=None, type=int,
                   help="Ranks to start (default: one per visible card, "
                        "through launch).")
    return p.parse_args(argv)


def stripe_np(a: np.ndarray, sp: int) -> np.ndarray:
    """:func:`stripe_tokens` of a (B, S) array along S, in numpy (the
    host data path)."""
    b, s = a.shape
    return a.reshape(b, s // sp, sp).swapaxes(1, 2).reshape(b, s)


def main_worker(rank, world_size, argv=None, quiet=False, history=None,
                init_params=None):
    """One rank of the run. ``history`` (a list) gets the loss of every
    step after the first; ``init_params`` (a JAX param tree of numpy
    arrays) replaces the seed-0 weights. Returns ``{"history",
    "steps_per_s", "tokens_per_s", "mesh"}``."""
    if world_size > 1:
        dist.init_process_group(rank, world_size)
    args = parse_args(argv)
    device = rank_device(world_size, args.device)
    n_dev = max(dist.get_world_size(), 1)
    sp = args.sp or n_dev
    if n_dev % sp:
        raise ValueError(f"sp={sp} must divide the {n_dev} ranks")
    dp = n_dev // sp
    if args.seq_len % sp:
        raise ValueError(f"--seq-len {args.seq_len} must divide by sp={sp}")
    if args.batch_size % dp:
        raise ValueError(f"--batch-size {args.batch_size} must divide by "
                         f"dp={dp}")
    mesh = context.init_mesh(dp=dp, sp=sp) if world_size > 1 \
        else context.get_mesh()
    if not quiet:
        dist.print_primary(f"mesh: dp={dp} x sp={sp}  seq {args.seq_len} "
                           f"({args.seq_len // sp}/rank)")

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    striped = args.sp_core == "striped"
    attn_fn = make_gspmd_ring_attn_fn(mesh, core=args.sp_core,
                                      block_q=args.block_q,
                                      block_k=args.block_k,
                                      window=args.window)
    model = TransformerLM(vocab=256, dim=args.dim, n_layers=args.n_layers,
                          n_heads=args.n_heads, max_seq=args.seq_len,
                          attn_fn=attn_fn, dtype=dtype, device=device,
                          generator=default_generator(device, 0))
    if init_params is not None:
        from distributed_pytorch_tpu_torch import from_jax_params
        from_jax_params(init_params, model)
    if world_size > 1:
        model = shard_params(model, transformer_lm_param_specs(model), mesh)
    optimizer = adamw(args.lr)
    opt_state = optimizer.init(model.parameters())

    positions = (stripe_tokens(torch.arange(args.seq_len, device=device),
                               sp, axis=0) if striped else None)

    def loss_fn(m, batch):
        x, y = batch
        logits = m(x, positions=positions)
        return cross_entropy_per_example(logits, y).mean(), {}

    step = make_spmd_train_step(loss_fn, optimizer, donate=False)

    # one seeded (B, S + 1) byte batch, as the JAX example's
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (args.batch_size, args.seq_len + 1)) \
        .astype(np.int64)
    x_np, y_np = toks[:, :-1], toks[:, 1:]
    if striped:
        x_np, y_np = stripe_np(x_np, sp), stripe_np(y_np, sp)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (x_np, y_np))
    if world_size > 1:
        batch = shard_batch_spec(batch, mesh, P("dp", "sp"))

    logger = MetricsLogger(args.log)
    tokens_per_step = args.batch_size * args.seq_len
    out = step(model, opt_state, batch)      # the first step: untimed
    float(out.loss)
    t0 = time.perf_counter()
    opt_state = out.opt_state
    losses = []
    for s in range(1, args.steps):
        out = step(model, opt_state, batch)
        opt_state = out.opt_state
        loss = float(out.loss)
        losses.append(loss)
        logger.log(s, loss=loss)
        if history is not None:
            history.append(loss)
        if not quiet and (s % 5 == 0 or s == args.steps - 1):
            dist.print_primary(f"step {s:>4}  loss {loss:.4f}")
    rec = {"history": losses, "steps_per_s": None, "tokens_per_s": None,
           "mesh": {"dp": dp, "sp": sp}}
    if args.steps > 1:
        sps = (args.steps - 1) / (time.perf_counter() - t0)
        rec.update(steps_per_s=sps, tokens_per_s=sps * tokens_per_step)
        if not quiet:
            dist.print_primary(f"done: {sps:.2f} steps/s, "
                               f"{sps * tokens_per_step:,.0f} tokens/s")
    logger.close()
    dist.cleanup()
    return rec


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.nprocs is not None:
        dist.launch_multiprocess(main_worker, args.nprocs, argv,
                                 device=args.device)
    elif args.device == "cpu":
        main_worker(0, 0, argv)
    else:
        dist.launch(main_worker, argv)


if __name__ == "__main__":
    main()
