"""A TransformerLM trained through the helper API: the DDP front door at
LM scale.

Every rank draws batches of ``SyntheticLM`` through ``data_sampler`` and
``DataLoader``, moves them to its device, and trains the model that
``prepare_ddp_model`` returned with ``make_train_step`` (the gradients
averaged over the ranks each step); after each step it meets the other
ranks (``wait_for_everyone``), sums the losses into rank 0 (``reduce``)
and gathers a per-example metric there (``gather``). Metrics stay on
the device until the run ends, so no step waits for the device.

Run (one rank per visible card; ``--device cpu --nprocs 2`` for two CPU
ranks over gloo)::

    python -m distributed_pytorch_tpu_torch.examples.ddp_lm --steps 12
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

import distributed_pytorch_tpu_torch as dist
from distributed_pytorch_tpu_torch.data import DataLoader, SyntheticLM
from distributed_pytorch_tpu_torch.examples.min_ddp import rank_device
from distributed_pytorch_tpu_torch.models import TransformerLM
from distributed_pytorch_tpu_torch.ops.flash_attention import \
    make_flash_attn_fn
from distributed_pytorch_tpu_torch.ops.losses import \
    cross_entropy_per_example
from distributed_pytorch_tpu_torch.optim import adamw
from distributed_pytorch_tpu_torch.parallel import (DataParallel,
                                                    make_train_step)

#: ``benchmarks/mfu_transformer.py:72`` FLAGSHIP with learned positions
FLAGSHIP = dict(vocab=32000, dim=768, n_layers=12, n_heads=12,
                max_seq=1024, pos="learned")


@dataclasses.dataclass
class Config:
    """One run. ``batch_size`` is per rank; ``data_size`` samples of
    ``seq_len + 1`` tokens and the weights are drawn from seed 0 (or the
    weights loaded from ``init_state``); the first ``warmup`` steps are
    left out of ``timed_s``. Attention goes through the flash kernels
    (dense below ``DPX_FLASH_MIN_SEQ`` keys)."""

    model: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(FLAGSHIP))
    seq_len: int = 1024
    batch_size: int = 8
    data_size: int = 16
    steps: int = 12
    warmup: int = 2
    lr: float = 3e-4
    dtype: str = "bfloat16"             # the parameters' dtype
    mixed_precision: str = "off"
    device: Optional[str] = None        # "cpu", or None for the card
    init_state: Optional[Dict[str, np.ndarray]] = None
    record_params: bool = False         # keep the params after each step


def lm_loss(model, batch):
    """Mean next-token cross-entropy, and each example's mean."""
    x, y = batch
    per_token = cross_entropy_per_example(model(x), y)
    return per_token.mean(), {"example_loss": per_token.mean(-1)}


def _params_np(model) -> Dict[str, np.ndarray]:
    """The parameters by the unwrapped model's names."""
    if isinstance(model, DataParallel):
        model = model.module
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in model.named_parameters()}


def main_worker(rank: int, world_size: int, cfg: Config,
                out_dir: Optional[str] = None) -> Dict[str, Any]:
    """Train ``cfg.steps`` steps; returns this rank's record (and saves
    it as ``<out_dir>/rank<r>.pt`` when ``out_dir`` is given)."""
    if world_size > 1:
        dist.init_process_group(rank, world_size)
    device = rank_device(world_size, cfg.device)
    distributed = dist.get_world_size() > 1

    data = SyntheticLM(cfg.data_size, cfg.seq_len, cfg.model["vocab"])
    sampler = dist.data_sampler(data, distributed, shuffle=True)
    loader = DataLoader(data, cfg.batch_size, sampler=sampler,
                        shuffle=sampler is None)

    gen = (torch.Generator(device=device) if device.type == "cuda"
           else torch.Generator()).manual_seed(0)
    model = TransformerLM(dtype=getattr(torch, cfg.dtype), device=device,
                          attn_fn=make_flash_attn_fn(), generator=gen,
                          **cfg.model)
    if cfg.init_state is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in cfg.init_state.items()})
    model = dist.prepare_ddp_model(model, device_ids=[rank])
    optimizer = adamw(cfg.lr)
    step = make_train_step(lm_loss, optimizer,
                           mixed_precision=cfg.mixed_precision)
    opt_state = optimizer.init(model.parameters())

    losses, reduced, gathered, params = [], [], [], []
    host = {"data": 0.0, "step": 0.0, "sync": 0.0}
    batches, epoch = iter(loader), 0
    t_start = time.perf_counter()
    for i in range(cfg.steps):
        if i == cfg.warmup:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_start = time.perf_counter()
        t0 = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            epoch += 1
            loader.set_epoch(epoch)
            batches = iter(loader)
            batch = next(batches)
        x, y = (t.to(device, non_blocking=True) for t in batch)
        t1 = time.perf_counter()
        out = step(model, opt_state, (x, y))
        opt_state = out.opt_state
        t2 = time.perf_counter()
        dist.wait_for_everyone()
        losses.append(out.loss)
        reduced.append(dist.reduce(out.loss.clone()))
        gathered.append(dist.gather(out.metrics["example_loss"]))
        t3 = time.perf_counter()
        if i >= cfg.warmup:
            host["data"] += t1 - t0
            host["step"] += t2 - t1
            host["sync"] += t3 - t2
        if cfg.record_params:
            params.append(_params_np(model))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timed = cfg.steps - cfg.warmup
    record = {
        "rank": rank, "world_size": dist.get_world_size(),
        "device": str(device),
        "timed_s": (time.perf_counter() - t_start) if timed > 0 else None,
        "host_ms_per_step": ({k: v / timed * 1e3 for k, v in host.items()}
                             if timed > 0 else None),
        "losses": torch.cat(losses).tolist(),
        "reduced": torch.cat(reduced).tolist(),
        "gathered": [torch.cat(g).tolist() for g in gathered],
        "param_dtypes": sorted({str(p.dtype) for p in model.parameters()}),
        "params": params,
    }
    if out_dir is not None:
        torch.save(record, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.cleanup()
    return record


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", default=12, type=int)
    parser.add_argument("--batch-size", default=8, type=int)
    parser.add_argument("--mixed-precision", default="off",
                        choices=("off", "bf16"))
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"))
    parser.add_argument("--nprocs", default=None, type=int)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    cfg = Config(steps=args.steps, batch_size=args.batch_size,
                 mixed_precision=args.mixed_precision, device=args.device,
                 dtype="float32" if args.mixed_precision == "bf16"
                 else "bfloat16")
    if args.nprocs is not None:
        dist.launch_multiprocess(main_worker, args.nprocs, cfg,
                                 device=args.device)
    else:
        dist.launch(main_worker, cfg)


if __name__ == "__main__":
    main()
