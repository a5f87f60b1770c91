"""ResNet-18 image classification: the vision rung (BASELINE.md: ResNet-18
on CIFAR-10).

Counterpart of the JAX package's ``examples/train_resnet.py``, with its
flags and defaults. Nothing is downloaded: with ``--data-dir`` naming a
directory that holds an extracted ``cifar-10-batches-py`` (the standard
python pickle batches) it trains on CIFAR-10, read with numpy; otherwise
on the seeded ``SyntheticImages``. SGD with momentum through
``make_stateful_train_step``: each rank keeps its own BatchNorm running
stats (torch DDP's BatchNorm), or syncs the batch statistics with
``--sync-bn``. The loop reads nothing from the device until an epoch
ends.

Run (one rank per visible card; ``--device cpu --nprocs 2`` for two CPU
ranks over gloo)::

    python -m distributed_pytorch_tpu_torch.examples.train_resnet \\
        --epochs 2 --batch-size 64
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import pickle
import sys
import time
from typing import Any, Optional

import numpy as np
import torch

import distributed_pytorch_tpu_torch as dist
from distributed_pytorch_tpu_torch import from_jax_params, optim, to_jax_state
from distributed_pytorch_tpu_torch.data import DataLoader, SyntheticImages
from distributed_pytorch_tpu_torch.examples.min_ddp import rank_device
from distributed_pytorch_tpu_torch.models import ResNet18
from distributed_pytorch_tpu_torch.ops.losses import \
    cross_entropy_per_example
from distributed_pytorch_tpu_torch.parallel import (make_stateful_eval_step,
                                                    make_stateful_train_step)
from distributed_pytorch_tpu_torch.runtime.device import default_generator
from distributed_pytorch_tpu_torch.utils import MetricsLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ResNet-18 training")
    p.add_argument("--epochs", default=2, type=int)
    p.add_argument("--batch-size", default=64, type=int,
                   help="Per-rank batch size.")
    p.add_argument("--lr", default=0.05, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--data-dir", default=None, type=str,
                   help="Path containing cifar-10-batches-py (no download "
                        "is attempted); default: synthetic images.")
    p.add_argument("--data-size", default=2048, type=int,
                   help="Synthetic dataset size when --data-dir is unset.")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--sync-bn", action="store_true",
                   help="BatchNorm statistics over the whole batch of all "
                        "ranks (torch nn.SyncBatchNorm); default: each "
                        "rank's own, as torch DDP's BatchNorm.")
    p.add_argument("--limit-steps", default=None, type=int,
                   help="Cap steps per epoch (smoke runs).")
    p.add_argument("--ema", default=0.0, type=float, metavar="DECAY",
                   help="Track an EMA of the weights (optim.with_ema) and "
                        "report eval accuracy with both the raw and the "
                        "averaged weights (the BN running stats come from "
                        "the raw trajectory, so the EMA number reads low).")
    p.add_argument("--eval", action="store_true",
                   help="Evaluate after each epoch on the held-out split "
                        "(CIFAR test_batch, or 10%% of synthetic data).")
    p.add_argument("--log", default=None, type=str)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="Run on the CPU, or on the card (default).")
    p.add_argument("--nprocs", default=None, type=int,
                   help="Ranks to start (default: one per visible card, "
                        "through launch).")
    return p.parse_args(argv)


class Cifar10:
    """CIFAR-10 from the standard python pickle batches, read with numpy
    alone: NHWC float32 in [0, 1], normalized per channel."""

    MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
    STD = np.array([0.2470, 0.2435, 0.2616], np.float32)

    def __init__(self, root: str, split: str = "train"):
        d = os.path.join(root, "cifar-10-batches-py")
        if not os.path.isdir(d):
            raise FileNotFoundError(f"{d} not found")
        files = ([f"data_batch_{i}" for i in range(1, 6)]
                 if split == "train" else ["test_batch"])
        xs, ys = [], []
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            xs.append(batch[b"data"])
            ys.extend(batch[b"labels"])
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        x = x.astype(np.float32) / 255.0
        self.images = (x - self.MEAN) / self.STD
        self.labels = np.asarray(ys, np.int32)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]

    def __len__(self):
        return len(self.labels)


@dataclasses.dataclass
class Trainer:
    """The model, its optimizer state and the steps of one run."""

    model: ResNet18
    opt_state: Any
    step_fn: Any
    eval_step: Any
    device: torch.device

    def train_step(self, batch):
        """One step on a host batch (x, y); returns the step's output."""
        x, y = (t.to(self.device, non_blocking=True) for t in batch)
        out = self.step_fn(self.model, self.opt_state, (x, y))
        self.opt_state = out.opt_state
        return out

    def evaluate(self, loader, ema: bool = False) -> np.ndarray:
        """Per-example correctness over ``loader``, every rank's in rank
        order; with ``ema`` the averaged weights and this rank's running
        stats."""
        model = self.model
        if ema:
            model = copy.deepcopy(self.model)
            params = list(model.parameters())
            with torch.no_grad():
                torch._foreach_copy_(params, optim.ema_params(
                    self.opt_state, like=params))
        return torch.cat([self.eval_step(model, tuple(
            t.to(self.device) for t in b)) for b in loader]).cpu().numpy()


def resnet_loss(model, batch):
    x, y = batch
    logits = model(x)
    correct = logits.argmax(dim=-1) == y
    return cross_entropy_per_example(logits, y).mean(), {"correct": correct}


def resnet_correct(model, batch):
    x, y = batch
    return model(x).argmax(dim=-1) == y


def make_trainer(args, device: torch.device,
                 init_params: Optional[dict] = None) -> Trainer:
    """The run's model (seed 0, or ``init_params``, a JAX param tree of
    numpy arrays), optimizer and steps."""
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = ResNet18(n_classes=10, small_input=True, sync_bn=args.sync_bn,
                     dtype=dtype, device=device,
                     generator=default_generator(device, 0))
    if init_params is not None:
        from_jax_params(init_params, model)
    # at world > 1 its wrapper broadcasts rank 0's weights; the steps run
    # on the model itself (make_train_step averages the gradients)
    dist.prepare_ddp_model(model)
    optimizer = optim.sgd(args.lr, momentum=args.momentum)
    if args.ema:
        optimizer = optim.with_ema(optimizer, decay=args.ema)
    return Trainer(model=model, opt_state=optimizer.init(model.parameters()),
                   step_fn=make_stateful_train_step(resnet_loss, optimizer),
                   eval_step=make_stateful_eval_step(resnet_correct),
                   device=device)


def main_worker(rank, world_size, argv=None, quiet=False, history=None,
                out_dir=None, init_params=None):
    """One rank of the run. ``history`` (a list) gets the loss of every
    step, the mean over the ranks; ``out_dir`` gets this rank's record
    as ``rank<r>.pt``. Returns the record: losses, eval accuracies,
    the BatchNorm state (JAX layout), and the training loops' time after
    the first step."""
    if world_size > 1:
        dist.init_process_group(rank, world_size)
    args = parse_args(argv)
    if not quiet:
        for name, val in vars(args).items():
            dist.print_primary("{:<12}: {}".format(name, val))
    device = rank_device(world_size, args.device)
    world = dist.get_world_size()
    distributed = world > 1

    if args.data_dir:
        dataset = Cifar10(args.data_dir)
        eval_set = Cifar10(args.data_dir, split="test") if args.eval else None
    else:
        dataset = SyntheticImages(args.data_size)
        eval_set = (SyntheticImages(max(args.data_size // 10,
                                        args.batch_size * world), seed=1)
                    if args.eval else None)
    sampler = dist.data_sampler(dataset, distributed, shuffle=True)
    loader = DataLoader(dataset, args.batch_size, sampler=sampler,
                        shuffle=sampler is None, drop_last=True)
    if len(loader) == 0:
        raise ValueError(
            f"batch size {args.batch_size} x {world} ranks exceeds the "
            f"{len(dataset)}-sample dataset (drop_last): no full batch to "
            "train on")
    eval_loader = None
    if eval_set is not None:
        eval_loader = DataLoader(eval_set, args.batch_size,
                                 sampler=dist.data_sampler(
                                     eval_set, distributed, shuffle=False),
                                 drop_last=True)

    trainer = make_trainer(args, device, init_params)
    logger = MetricsLogger(args.log)
    record = {"rank": dist.get_rank(), "world_size": world,
              "device": str(device), "losses": [], "local_losses": [],
              "train_acc": [], "eval_acc": [], "ema_eval_acc": []}
    timed_s, timed_steps = 0.0, 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        dev_losses, dev_correct, n_seen = [], [], 0
        # the first step (cuDNN's algorithm search) is not timed
        t0 = None if epoch == 0 else time.perf_counter()
        for it, batch in enumerate(loader):
            if args.limit_steps is not None and it >= args.limit_steps:
                break
            out = trainer.train_step(batch)
            dev_losses.append(out.loss)
            dev_correct.append(out.metrics["correct"].sum())
            n_seen += world * args.batch_size
            if t0 is None:
                sync()
                t0 = time.perf_counter()
            else:
                timed_steps += 1
        # the epoch's first read of the device
        local = torch.cat(dev_losses)
        losses = dist.all_reduce(local.clone(), "avg").tolist()
        correct = int(dist.all_reduce(torch.stack(dev_correct).sum(),
                                      "sum").item())
        timed_s += time.perf_counter() - t0
        record["local_losses"] += local.tolist()
        record["losses"] += losses
        record["train_acc"].append(correct / max(n_seen, 1))
        if history is not None:
            history.extend(losses)
        for i, loss in enumerate(losses):
            logger.log(epoch * len(loader) + i, loss=loss)
        if not quiet:
            dist.print_primary(f"epoch {epoch}: acc "
                               f"{correct / max(n_seen, 1):.4f} loss "
                               f"{losses[-1]:.4f}")
        if eval_loader is not None:
            for tag, ema in [("", False)] + [("ema_", True)] * bool(args.ema):
                corr = trainer.evaluate(eval_loader, ema=ema)
                record[f"{tag}eval_acc"].append(float(corr.mean()))
                logger.log(epoch, **{f"{tag}eval_acc": corr.mean()})
                if not quiet:
                    dist.print_primary(
                        f"epoch {epoch}: EVAL{' (ema)' if ema else ''} acc "
                        f"{corr.mean():.4f} ({int(corr.sum())}/{corr.size})")
    sync()
    record.update(timed_s=timed_s, timed_steps=timed_steps,
                  state=to_jax_state(trainer.model))
    if timed_steps and not quiet:
        sps = timed_steps / timed_s
        dist.print_primary(f"done: {sps:.2f} steps/s, "
                           f"{sps * world * args.batch_size:,.0f} images/s")
    if out_dir is not None:
        torch.save(record, os.path.join(out_dir, f"rank{rank}.pt"))
    logger.close()
    dist.cleanup()
    return record


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
