"""min_ddp: the reference workload (``min_DDP.py``) on the port.

Counterpart of the JAX package's ``examples/min_ddp.py`` and
``examples/min_ddp_multiprocess.py`` in one worker: in PyTorch,
``launch`` at world > 1 is the multi-process door. The same five flags
and defaults, seeded dataset, model, optimizer and prints as the
reference; ``reduce`` is a SUM although the reference's comment says
average (its quirk), and ``gather`` feeds the global accuracy.

Run::

    python -m distributed_pytorch_tpu_torch.examples.min_ddp
        # one process per visible card (world 0 on a host without one)
    python -m distributed_pytorch_tpu_torch.examples.min_ddp --device cpu
        # one process on the CPU
    python -m distributed_pytorch_tpu_torch.examples.min_ddp \\
        --device cpu --nprocs 2 --batch-size 4
        # two CPU ranks over gloo
    DPX_BACKEND=host python -m distributed_pytorch_tpu_torch.examples.min_ddp \\
        --device cpu --nprocs 2 --batch-size 4 --grad-reduce quant
        # two CPU ranks over the native host group, quantized gradients
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

import distributed_pytorch_tpu_torch as dist
from distributed_pytorch_tpu_torch.data import DataLoader, DummyDataset
from distributed_pytorch_tpu_torch.models import DummyModel
from distributed_pytorch_tpu_torch.ops.losses import \
    cross_entropy_per_example
from distributed_pytorch_tpu_torch.optim import adamw
from distributed_pytorch_tpu_torch.parallel import make_train_step
from distributed_pytorch_tpu_torch.parallel.data_parallel import \
    GRAD_REDUCE_MODES
from distributed_pytorch_tpu_torch.runtime import faults


def parse_args(argv=None):
    # the reference's five flags and defaults (min_DDP.py:10-24)
    parser = argparse.ArgumentParser(description="Multi-GPU Training")
    parser.add_argument("--epochs", default=2, type=int, metavar="N",
                        help="Number of training epochs.")
    parser.add_argument("--batch-size", default=8, type=int, metavar="N",
                        help="Per-rank batch size.")
    parser.add_argument("--n-classes", default=4, type=int, metavar="N",
                        help="Number of classes for fake dataset.")
    parser.add_argument("--data-size", default=32, type=int, metavar="N",
                        help="Size of fake dataset.")
    parser.add_argument("--hidden-dim", default=32, type=int, metavar="N",
                        help="Hidden dimension.")
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"),
                        help="Run on the CPU, or on the card (default: "
                             "the card; the CPU where launch finds none).")
    parser.add_argument("--nprocs", default=None, type=int, metavar="N",
                        help="Ranks to start (default: one per visible "
                             "card, through launch).")
    parser.add_argument("--grad-reduce", default="mean",
                        choices=GRAD_REDUCE_MODES,
                        help="Gradient wire: the exact mean, or the "
                             "block-quantized ring (quant/int8, q4, "
                             "adaptive) with error feedback.")
    parser.add_argument("--weight-update", default=None,
                        choices=("replicated", "sharded"),
                        help="Every rank's full update, or ZeRO-1 over "
                             "the owned 1/world slice (default: "
                             "DPX_WEIGHT_UPDATE).")
    return parser.parse_args(argv)


def rank_device(world_size: int, want: Optional[str]) -> torch.device:
    """The device of this rank: the group's at world > 1; the CPU when
    asked for, or at world 0 (the reference's CPU branch); else the
    card, which raises where there is none."""
    if world_size > 1:
        return dist.get_device()
    if want == "cpu" or (want is None and world_size == 0):
        return torch.device("cpu")
    return dist.get_device()


def main_worker(rank, world_size, argv=None, quiet=False, history_path=None,
                init_state=None, shuffle=None):
    """One rank of the workload (reference ``min_DDP.py:53-89``).

    ``history_path``: the primary writes its reduced loss per step there
    as a JSON list. ``init_state``: a state dict (numpy arrays) to start
    from instead of the seed-0 weights. ``shuffle`` overrides the
    reference's loader choice (shuffle iff not distributed)."""
    is_distributed = world_size > 1
    if is_distributed:
        dist.init_process_group(rank, world_size)
    args = parse_args(argv)
    device = rank_device(world_size, args.device)
    if not quiet:
        for name, val in vars(args).items():
            dist.print_primary("{:<12}: {}".format(name, val))

    # data, seeded identically in every rank (min_DDP.py:27-38, 63-66)
    dataset = DummyDataset(args.data_size, args.n_classes)
    sampler = dist.data_sampler(dataset, is_distributed, shuffle=False)
    loader = DataLoader(dataset, batch_size=args.batch_size,
                        shuffle=(sampler is None) if shuffle is None
                        else shuffle, sampler=sampler)

    # model: drawn on the CPU from one seed, so every device starts from
    # the same weights; prepare_ddp_model broadcasts rank 0's
    model = DummyModel(1, args.hidden_dim, args.n_classes, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    if init_state is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in init_state.items()})
    model = dist.prepare_ddp_model(model.to(device), device_ids=[rank])

    # optimizer and loss (min_DDP.py:74-75)
    optimizer = adamw(0.0001)

    def loss_fn(m, batch):
        x, y = batch
        logits = m(x)
        preds = logits.argmax(-1)
        return (cross_entropy_per_example(logits, y).mean(),
                {"preds": preds, "correct": preds == y})

    step = make_train_step(loss_fn, optimizer, grad_reduce=args.grad_reduce,
                           weight_update=args.weight_update)
    opt_state = (step.init_opt_state(model.parameters())
                 if hasattr(step, "init_opt_state")
                 else optimizer.init(model.parameters()))

    history = []
    if not quiet:
        dist.print_primary("Run epochs")
    for epoch in range(args.epochs):
        if not quiet:
            dist.print_primary(f"------- Epoch {epoch + 1}")
        if is_distributed:
            sampler.set_epoch(epoch)
        for it, (x, y) in enumerate(loader):
            # the DPX_FAULT step hook (runtime/faults.py; a no-op unarmed)
            faults.on_step(epoch * len(loader) + it, rank=dist.get_rank())
            x, y = x.to(device), y.to(device)
            out = step(model, opt_state, (x, y))
            opt_state = out.opt_state
            correct = out.metrics["correct"]

            # per-rank diagnostics (min_DDP.py:110-116)
            if not quiet:
                n = len(y)
                c = int(correct.sum())
                print(f"Device: {device}"
                      f"\n\tInput: \t{x[:, 0].cpu().numpy().astype(np.uint8)}"
                      f"\n\tLabel: \t{y.cpu().numpy()}"
                      f"\n\tPred:  \t{out.metrics['preds'].cpu().numpy()}"
                      f"\n\tCorr.: \t{correct.cpu().numpy().astype(np.uint8)}"
                      f"\n\tAcc:   \t{c / n:.5f} ({c}/{n})"
                      f"\n\tLoss:  \t{out.loss.item():.5f}", flush=True)

            # barrier, then the cross-rank metrics (min_DDP.py:119-130)
            dist.wait_for_everyone()
            loss = dist.reduce(out.loss)
            gathered = dist.gather(correct.to(torch.uint8))
            if dist.is_primary():
                history.append(loss.item())
                all_correct = torch.cat(gathered)
                if not quiet:
                    c = int(all_correct.sum())
                    print(f"Finish iteration {it} - acc: "
                          f"{c / all_correct.numel():.4f} "
                          f"({c}/{all_correct.numel()}) - loss: "
                          f"{history[-1]:.4f}", flush=True)

    if history_path is not None and dist.is_primary():
        with open(history_path, "w") as f:
            json.dump(history, f)
    dist.cleanup()


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
