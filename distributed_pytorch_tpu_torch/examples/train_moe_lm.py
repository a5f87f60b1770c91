"""Expert-parallel MoE LM training: experts sharded over the ``ep`` axis.

Counterpart of the JAX package's ``examples/train_moe_lm.py``, with its
arguments plus ``--device`` and ``--nprocs``. ``MoETransformerLM`` swaps
every block's dense MLP for a bank of expert FFNs whose weights carry
``P("ep", ...)`` specs (``parallel/moe.py``): on a ``dp x ep`` mesh of
the ranks each ep rank keeps E/ep experts and the routed outputs are
summed over ep. Both routers are exposed: token-choice top-k (Switch /
GShard, trainable load-balancing aux) and expert-choice. The router
metrics (drop rate, max expert load, z-loss) go to the line-JSON log.
At one rank there is no mesh: plain tensors, every expert local.

The data are the JAX example's: one seeded (B, S + 1) byte batch
(``numpy.random.default_rng(0)``) trained on every step; the loss of
every step after the first goes to ``history``.

Run (one rank per visible card; ``--device cpu --nprocs 2`` for two CPU
ranks over gloo)::

    python -m distributed_pytorch_tpu_torch.examples.train_moe_lm --steps 20 --n-experts 4 --top-k 2
    python -m distributed_pytorch_tpu_torch.examples.train_moe_lm --device cpu --nprocs 2 --ep 2 --steps 6 --seq-len 32 --dim 32 --n-layers 1
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

import distributed_pytorch_tpu_torch as dist
from distributed_pytorch_tpu_torch.examples.min_ddp import rank_device
from distributed_pytorch_tpu_torch.models import MoETransformerLM
from distributed_pytorch_tpu_torch.ops.losses import \
    cross_entropy_per_example
from distributed_pytorch_tpu_torch.optim import adamw
from distributed_pytorch_tpu_torch.parallel import (make_spmd_train_step,
                                                    shard_batch_spec)
from distributed_pytorch_tpu_torch.parallel.tensor import P, shard_params
from distributed_pytorch_tpu_torch.runtime import context
from distributed_pytorch_tpu_torch.runtime.device import default_generator
from distributed_pytorch_tpu_torch.utils import MetricsLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Expert-parallel MoE LM training")
    p.add_argument("--steps", default=20, type=int)
    p.add_argument("--seq-len", default=128, type=int)
    p.add_argument("--batch-size", default=8, type=int,
                   help="GLOBAL batch (sharded over the dp axis).")
    p.add_argument("--ep", default=0, type=int,
                   help="Expert-parallel axis size; 0 = all ranks. The "
                        "rest becomes dp.")
    p.add_argument("--n-experts", default=0, type=int,
                   help="0 = one expert per ep rank.")
    p.add_argument("--top-k", default=1, type=int,
                   help="token-choice routing fan-out (1=Switch, 2=GShard)")
    p.add_argument("--router", default="tokens",
                   choices=["tokens", "experts"],
                   help="experts = expert-choice routing: exact load "
                        "balance, no aux loss (training-only scheme)")
    p.add_argument("--capacity-factor", default=2.0, type=float)
    p.add_argument("--shared-experts", default=0, type=int,
                   help="DeepSeekMoE-style always-on shared experts (a "
                        "dense FFN of this many expert widths added to "
                        "the routed output; replicated over ep).")
    p.add_argument("--aux-coef", default=0.01, type=float,
                   help="weight of the combined router aux in the loss")
    p.add_argument("--dim", default=128, type=int)
    p.add_argument("--n-layers", default=2, type=int)
    p.add_argument("--n-heads", default=4, type=int)
    p.add_argument("--pos", default="learned",
                   choices=["learned", "rope", "none"])
    p.add_argument("--lr", default=3e-4, type=float)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--log", default=None, type=str)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="Run on the CPU, or on the card (default).")
    p.add_argument("--nprocs", default=None, type=int,
                   help="Ranks to start (default: one per visible card, "
                        "through launch).")
    return p.parse_args(argv)


def main_worker(rank, world_size, argv=None, quiet=False, history=None,
                init_params=None):
    """One rank of the run. ``history`` (a list) gets the loss of every
    step after the first; ``init_params`` (a JAX param tree of numpy
    arrays) replaces the seed-0 weights. Returns ``{"history",
    "metrics", "steps_per_s", "tokens_per_s", "mesh"}``."""
    if world_size > 1:
        dist.init_process_group(rank, world_size)
    args = parse_args(argv)
    device = rank_device(world_size, args.device)
    n_dev = max(dist.get_world_size(), 1)
    ep = args.ep or n_dev
    if n_dev % ep:
        raise ValueError(f"ep={ep} must divide the {n_dev} ranks")
    dp = n_dev // ep
    if args.batch_size % dp:
        raise ValueError(f"--batch-size {args.batch_size} must divide by "
                         f"dp={dp}")
    n_experts = args.n_experts or ep
    if n_experts % ep:
        raise ValueError(f"--n-experts {n_experts} must divide by ep={ep}")
    mesh = context.init_mesh(dp=dp, ep=ep) if world_size > 1 else None
    if not quiet:
        dist.print_primary(f"mesh: dp={dp} x ep={ep}  experts={n_experts} "
                           f"router={args.router} top_k={args.top_k}")

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = MoETransformerLM(
        vocab=256, dim=args.dim, n_layers=args.n_layers,
        n_heads=args.n_heads, n_experts=n_experts, max_seq=args.seq_len,
        capacity_factor=args.capacity_factor, top_k=args.top_k,
        router=args.router, n_shared_experts=args.shared_experts,
        pos=args.pos, dtype=dtype, device=device,
        generator=default_generator(device, 0))
    if init_params is not None:
        from distributed_pytorch_tpu_torch import from_jax_params
        from_jax_params(init_params, model)
    if mesh is not None:
        model = shard_params(model, model.param_specs(), mesh)
    optimizer = adamw(args.lr)
    opt_state = optimizer.init(model.parameters())

    def loss_fn(m, batch):
        x, y = batch
        logits, aux, metrics = m.forward_with_metrics(x)
        nll = cross_entropy_per_example(logits, y).mean()
        diag = {"nll": nll, "aux": aux, "drop_rate": metrics["drop_rate"],
                "z_loss": metrics["z_loss"],
                "max_expert_load": metrics["expert_load"].max()}
        return nll + args.aux_coef * aux, diag

    step = make_spmd_train_step(loss_fn, optimizer, donate=False)

    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (args.batch_size, args.seq_len + 1)) \
        .astype(np.int64)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (toks[:, :-1], toks[:, 1:]))
    if mesh is not None:
        batch = shard_batch_spec(batch, mesh, P("dp", None))

    logger = MetricsLogger(args.log)
    tokens_per_step = args.batch_size * args.seq_len
    out = step(model, opt_state, batch)      # the first step: untimed
    float(out.loss)
    t0 = time.perf_counter()
    opt_state = out.opt_state
    losses, metrics = [], []
    for s in range(1, args.steps):
        out = step(model, opt_state, batch)
        opt_state = out.opt_state
        loss = float(out.loss)
        m = {k: float(v.float().mean()) for k, v in out.metrics.items()}
        logger.log(s, loss=loss, **m)
        losses.append(loss)
        metrics.append(m)
        if history is not None:
            history.append(loss)
        if not quiet and (s % 5 == 0 or s == args.steps - 1):
            dist.print_primary(
                f"step {s:>4}  loss {loss:.4f}  nll {m['nll']:.4f}  "
                f"drop {m['drop_rate']:.3f}  "
                f"max_load {m['max_expert_load']:.3f}")
    rec = {"history": losses, "metrics": metrics, "steps_per_s": None,
           "tokens_per_s": None, "mesh": {"dp": dp, "ep": ep}}
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
