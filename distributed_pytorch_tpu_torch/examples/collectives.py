"""Every helper of the API once per rank, and what each returned.

Rank r holds ``(r + 1) * [1, 2, 3]`` and runs each collective on it;
then every rank builds a ``DummyModel`` from a seed of its own and
passes it through ``prepare_ddp_model``. Each rank's observations go to
``<out_dir>/rank<r>.json`` (rank 0's are also printed), so a caller can
hold every rank to the reference's semantics: rank 0's values, the
other ranks' unchanged ``reduce`` buffers and zero ``gather`` lists, and
rank 0's weights everywhere after wrapping at world > 1. An integer
``avg`` runs on ``(r + 1) * [3, 4]``, and a ``MetricsLogger`` on
``<out_dir>/metrics.jsonl`` logs two steps and one event per rank.

Run::

    python -m distributed_pytorch_tpu_torch.examples.collectives
    python -m distributed_pytorch_tpu_torch.examples.collectives \\
        --device cpu --nprocs 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Optional

import torch

import distributed_pytorch_tpu_torch as dist
from distributed_pytorch_tpu_torch.examples.min_ddp import rank_device
from distributed_pytorch_tpu_torch.models import DummyModel
from distributed_pytorch_tpu_torch.utils import MetricsLogger


def rank_tensor(rank: int, device) -> torch.Tensor:
    """The payload of rank ``rank``: ``(rank + 1) * [1, 2, 3]``."""
    return (rank + 1.0) * torch.tensor([1.0, 2.0, 3.0], device=device)


def _flat_params(model) -> list:
    return torch.cat([p.detach().reshape(-1).cpu()
                      for p in model.parameters()]).tolist()


def main_worker(rank: int, world_size: int, out_dir: str,
                device: Optional[str] = None) -> None:
    if world_size > 1:
        dist.init_process_group(rank, world_size)
    dev = rank_device(world_size, device)
    world = dist.get_world_size()
    x = rank_tensor(rank, dev)
    outs = {}
    obs = {"rank": dist.get_rank(), "world_size": world,
           "initialized": dist.is_dist_avail_and_initialized(),
           "backend": dist.get_backend(), "device": str(dev),
           "is_primary": dist.is_primary()}
    if world > 1 or dev.type == "cuda":      # a card, or a group
        obs["get_device"] = str(dist.get_device())
        outs["replicate"] = dist.replicate([x.clone()])[0]
        outs["shard_batch"] = dist.shard_batch((x.cpu(),))[0]
    for op in ("sum", "avg", "max", "min"):
        outs[f"all_reduce_{op}"] = dist.all_reduce(x.clone(), op)
    x_int = (rank + 1) * torch.tensor([3, 4], device=dev)
    avg_int = dist.all_reduce(x_int, "avg")
    obs["all_reduce_avg_int64"] = avg_int.tolist()
    obs["all_reduce_avg_int64_dtype"] = str(avg_int.dtype)
    red_in = x.clone()
    outs["reduce"] = dist.reduce(red_in, "sum")
    obs["reduce_returns_its_input"] = outs["reduce"] is red_in
    gathered = dist.gather(x.clone())
    outs.update({f"gather_{r}": g for r, g in enumerate(gathered)})
    outs["broadcast_src1"] = dist.broadcast(x.clone(), src=min(1, world - 1))
    outs["all_gather"] = dist.all_gather(x.clone())
    outs["sync_params"] = dist.sync_params([x.clone()])[0]
    dist.barrier()
    dist.wait_for_everyone()
    try:
        dist.all_reduce(x.clone(), "prod")
        obs["invalid_op_raises"] = False
    except ValueError:
        obs["invalid_op_raises"] = True
    obs.update({k: v.tolist() for k, v in outs.items()})
    obs["gather"] = [obs.pop(f"gather_{r}") for r in range(len(gathered))]
    obs["output_devices"] = sorted({str(v.device) for v in outs.values()})
    obs["output_dtypes"] = sorted({str(v.dtype) for v in outs.values()})

    # DDP's constructor contract: ranks that start from different
    # weights hold rank 0's after prepare_ddp_model (at world > 1)
    model = DummyModel(device="cpu", generator=torch.Generator()
                       .manual_seed(rank)).to(dev)
    obs["params_before"] = _flat_params(model)
    wrapped = dist.prepare_ddp_model(model, device_ids=[rank])
    obs["prepare_ddp_model_wraps"] = wrapped is not model
    obs["params_after"] = _flat_params(wrapped)

    logger = MetricsLogger(os.path.join(out_dir, "metrics.jsonl"))
    for step in range(2):
        logger.log(step, loss=float(step))
    logger.event("rank_done", rank=rank)
    logger.close()

    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(obs, f)
    dist.cleanup()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"))
    parser.add_argument("--nprocs", default=None, type=int)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory() as out_dir:
        if args.nprocs is not None:
            dist.launch_multiprocess(main_worker, args.nprocs, out_dir,
                                     args.device, device=args.device)
        elif args.device == "cpu":
            main_worker(0, 0, out_dir, "cpu")
        else:
            dist.launch(main_worker, out_dir, args.device)
        with open(os.path.join(out_dir, "rank0.json")) as f:
            print(json.dumps(json.load(f)))


if __name__ == "__main__":
    main()
