"""Transformer-LM training: the language-model rung (BASELINE.md: a
Transformer LM), a decoder-only causal LM.

Counterpart of the JAX package's ``examples/train_transformer_lm.py``,
with its flags and defaults. Nothing is downloaded: it trains on a
local text corpus byte-tokenized (``--text``, a file or a directory such
as the Python standard library's source tree) or on the seeded
``SyntheticLM``. Each rank draws its batches through ``data_sampler``
and ``DataLoader`` (``--prefetch N``: a background thread puts them on
the device), trains with ``make_train_step`` (gradients averaged over
the ranks), and reads the losses from the device only every
``--log-every`` steps. ``--save DIR`` checkpoints every
``--save-every`` steps in the JAX package's on-disk format
(``utils/checkpoint.py``, async); ``--resume`` restores the latest step
and fast-forwards the data stream to it, so the continued losses are
those of an uninterrupted run. ``--eval`` reports the held-out loss,
``--generate N`` greedy-decodes N tokens, ``--trace DIR`` writes a
profile of steps 5-10. ``--fsdp`` trains in the ZeRO-3 layout over the
ranks (``parallel/fsdp.py``: FSDP2, the JAX spec of
``fsdp_param_specs``) when there is more than one; at world 1 it is the
plain step, as in the JAX package. A format-1 checkpoint is then written
from the gathered state, and ``--resume`` restores into the whole model
before it is sharded. ``--sharded-ckpt`` writes format 2 instead
(``ckpt/``): the specs of ``shard_layouts(n_shards=world)``, every rank
writing only the shards it owns (under ``--fsdp`` its local ones, never
gathered); ``--resume`` restores a format-2 checkpoint written at any
world size into this run's layout, each rank reading only the shards
that overlap what it holds.

``--elastic N`` (with ``--save``) runs the whole command in a
supervised child process (``runtime/elastic.py``) and relaunches it up
to N times when it dies, appending ``--resume`` once the save directory
holds a checkpoint of either format, so the relaunch continues exactly.
A fault can be injected with ``DPX_FAULT`` (``runtime/faults.py``),
e.g. ``DPX_FAULT=kill@op=ckpt_commit_window,call=2,attempt=0``. Under
``--elastic`` or with ``DPX_METRICS_LOG`` set, the primary ends with a
``metrics_snapshot`` (source ``train_end``) whose gauges hold the step
it started from (``train.start_step``), the wall time its first step
finished (``train.first_step_wall``, for which that step is waited
for) and each flash kernel's launches (``kernels.<name>.launches``).

Run (one rank per visible card; ``--device cpu`` on the CPU)::

    python -m distributed_pytorch_tpu_torch.examples.train_transformer_lm \\
        --steps 50 --flash --bf16
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

import distributed_pytorch_tpu_torch as dist
from distributed_pytorch_tpu_torch import from_jax_params, optim
from distributed_pytorch_tpu_torch.data import (DataLoader, SyntheticLM,
                                                device_prefetch)
from distributed_pytorch_tpu_torch.examples.min_ddp import rank_device
from distributed_pytorch_tpu_torch.models import TransformerLM
from distributed_pytorch_tpu_torch.models.generate import make_generate_fn
from distributed_pytorch_tpu_torch.obs import metrics as dpxmon
from distributed_pytorch_tpu_torch.obs.trace import wall_now
from distributed_pytorch_tpu_torch.ops import flash_attention
from distributed_pytorch_tpu_torch.ops.flash_attention import \
    make_flash_attn_fn
from distributed_pytorch_tpu_torch.ops.losses import (
    cross_entropy_per_example, fused_linear_cross_entropy)
from distributed_pytorch_tpu_torch.parallel import (fsdp, make_eval_step,
                                                    make_train_step)
from distributed_pytorch_tpu_torch.runtime import context, elastic
from distributed_pytorch_tpu_torch.runtime import env as _env
from distributed_pytorch_tpu_torch.runtime.context import map_tensors
from distributed_pytorch_tpu_torch.runtime.device import default_generator
from distributed_pytorch_tpu_torch.utils import MetricsLogger, profiler
from distributed_pytorch_tpu_torch.utils.checkpoint import latest_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Transformer-LM training")
    p.add_argument("--steps", default=100, type=int,
                   help="Total training steps (across epochs of the data).")
    p.add_argument("--batch-size", default=8, type=int,
                   help="Per-rank batch size.")
    p.add_argument("--seq-len", default=256, type=int)
    p.add_argument("--dim", default=256, type=int)
    p.add_argument("--n-layers", default=4, type=int)
    p.add_argument("--n-heads", default=8, type=int)
    p.add_argument("--n-kv-heads", default=None, type=int,
                   help="grouped-query attention: kv heads < n-heads")
    p.add_argument("--tie-embeddings", action="store_true",
                   help="share the token table with the vocab projection")
    p.add_argument("--pos", default="learned",
                   choices=["learned", "rope", "none"])
    p.add_argument("--lr", default=None, type=float,
                   help="default: 3e-4 for adamw and adamw8bit; unset "
                        "for adafactor (its relative-step mode)")
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "adafactor", "adamw8bit"])
    p.add_argument("--warmup-steps", default=0, type=int,
                   help="Linear warmup into cosine decay over --steps; "
                        "0 = constant lr.")
    p.add_argument("--clip-norm", default=0.0, type=float,
                   help="Clip gradients by global L2 norm; 0 = off.")
    p.add_argument("--text", default=None, type=str,
                   help="Local text file OR directory to byte-tokenize "
                        "(vocab=256; a directory concatenates its "
                        ".py/.md/.txt/.rst files up to a 64MiB cap); "
                        "default: seeded synthetic tokens.")
    p.add_argument("--data-size", default=512, type=int,
                   help="Number of synthetic samples when --text is unset.")
    p.add_argument("--flash", action="store_true",
                   help="Attention through the CUDA flash kernels.")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3 layout over the ranks (FSDP2; world > 1).")
    p.add_argument("--fused-ce", action="store_true",
                   help="stream the vocab projection through "
                        "fused_linear_cross_entropy (the logits never "
                        "materialize)")
    p.add_argument("--remat", action="store_true",
                   help="Recompute each block in backward.")
    p.add_argument("--master-f32", action="store_true",
                   help="With --bf16: float32 master weights in the "
                        "optimizer state.")
    p.add_argument("--trace", default=None, type=str,
                   help="Write a profile of steps 5-10 into DIR.")
    p.add_argument("--log", default=None, type=str,
                   help="Line-JSON metrics file.")
    p.add_argument("--prefetch", default=0, type=int, metavar="N",
                   help="Prefetch N batches onto the device from a "
                        "background thread.")
    p.add_argument("--log-every", default=10, type=int,
                   help="Steps between host syncs (loss read + log).")
    p.add_argument("--generate", default=0, type=int, metavar="N",
                   help="After training, greedy-decode N tokens from a "
                        "short prompt and print them.")
    p.add_argument("--eval", action="store_true",
                   help="Hold out 10%% of the data; report validation "
                        "loss and perplexity after training.")
    p.add_argument("--save", default=None, type=str, metavar="DIR",
                   help="Checkpoint directory (atomic, retention-managed).")
    p.add_argument("--save-every", default=50, type=int,
                   help="Steps between checkpoints when --save is set.")
    p.add_argument("--sharded-ckpt", action="store_true",
                   help="Sharded checkpoints (format 2): every rank "
                        "writes the shards it owns; --resume reshards "
                        "onto this run's world size.")
    p.add_argument("--resume", action="store_true",
                   help="Restore the latest checkpoint from --save and "
                        "continue exactly.")
    p.add_argument("--elastic", default=0, type=int, metavar="N",
                   help="Relaunch up to N times on failure, resuming "
                        "from --save (which it requires).")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="Run on the CPU, or on the card (default).")
    p.add_argument("--nprocs", default=None, type=int,
                   help="Ranks to start (default: one per visible card, "
                        "through launch).")
    return p.parse_args(argv)


class Subset:
    """Index-selected view of a dataset (the holdout split)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]

    def __len__(self):
        return len(self.indices)


class ByteCorpus:
    """Byte-level LM windows over a local text corpus: sample i is
    (bytes[i*S:(i+1)*S], shifted-by-one targets).

    ``path`` may be a file, or a directory whose ``.py/.md/.txt/.rst``
    files (sorted, recursive) are concatenated up to ``max_bytes``
    (default 64 MiB; truncation is reported on stderr)."""

    _EXTS = (".py", ".md", ".txt", ".rst")

    def __init__(self, path: str, seq_len: int, max_bytes: int = 1 << 26):
        if os.path.isdir(path):
            chunks, total = [], 0
            for root, dirs, files in os.walk(path):
                if total >= max_bytes:
                    break
                dirs.sort()
                for f in sorted(files):
                    if total >= max_bytes:
                        break
                    if f.endswith(self._EXTS):
                        try:
                            chunk = np.fromfile(os.path.join(root, f),
                                                dtype=np.uint8,
                                                count=max_bytes - total)
                        except OSError:
                            continue
                        chunks.append(chunk)
                        total += len(chunk)
            if not chunks:
                raise ValueError(f"{path}: no text files found")
            if total >= max_bytes:
                print(f"ByteCorpus: {path} truncated to {max_bytes} bytes "
                      f"(max_bytes cap)", file=sys.stderr)
            raw = np.concatenate(chunks)
        else:
            raw = np.fromfile(path, dtype=np.uint8)
        n = (len(raw) - 1) // seq_len
        if n < 1:
            raise ValueError(f"{path}: need > {seq_len + 1} bytes")
        self.x = raw[: n * seq_len].reshape(n, seq_len).astype(np.int32)
        self.y = raw[1 : n * seq_len + 1].reshape(n, seq_len).astype(np.int32)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def _optimizer(args):
    opt_fn = {"adamw": optim.adamw, "adafactor": optim.adafactor,
              "adamw8bit": optim.adamw_8bit}[args.optimizer]
    lr = args.lr if args.lr is not None else \
        (None if args.optimizer == "adafactor" else 3e-4)
    if args.warmup_steps >= args.steps > 0:
        raise ValueError(
            f"--warmup-steps {args.warmup_steps} must be < --steps "
            f"{args.steps} (the cosine phase would never run)")
    if args.warmup_steps > 0:
        if lr is None:
            raise ValueError(
                "--warmup-steps with adafactor needs an explicit --lr")
        optimizer = optim.with_schedule(
            opt_fn, optim.warmup_cosine(lr, args.warmup_steps, args.steps))
    else:
        optimizer = opt_fn(lr)
    if args.clip_norm > 0:
        optimizer = optim.with_clipping(optimizer, args.clip_norm)
    if args.master_f32:
        optimizer = optim.with_master_f32(optimizer)
    return optimizer


def main_worker(rank, world_size, argv=None, quiet=False, history=None,
                out_dir=None, init_params=None) -> Dict[str, Any]:
    """One rank of the run. ``history`` (a list) gets the loss of every
    step (the mean over the ranks); ``init_params`` (a JAX param tree of
    numpy arrays) replaces the seed-0 weights; ``out_dir`` gets this
    rank's record as ``rank<r>.pt``. Returns the record: losses, the
    step resumed from, eval nll, generated tokens, the timed window,
    data and checkpoint timings, the trace path."""
    is_distributed = world_size > 1
    if is_distributed:
        dist.init_process_group(rank, world_size)
    args = parse_args(argv)
    if not quiet:
        for name, val in vars(args).items():
            dist.print_primary("{:<12}: {}".format(name, val))
    device = rank_device(world_size, args.device)
    world = dist.get_world_size()

    vocab = 256
    if args.text:
        dataset = ByteCorpus(args.text, args.seq_len)
    else:
        dataset = SyntheticLM(args.data_size, args.seq_len, vocab)
    eval_set = None
    if args.eval:
        n = len(dataset)
        n_eval = max(n // 10, 1)
        dataset, eval_set = (Subset(dataset, np.arange(n - n_eval)),
                             Subset(dataset, np.arange(n - n_eval, n)))
    sampler = dist.data_sampler(dataset, is_distributed, shuffle=True)
    loader = DataLoader(dataset, batch_size=args.batch_size,
                        shuffle=(sampler is None), sampler=sampler,
                        drop_last=True)
    if len(loader) == 0:
        raise ValueError(
            f"batch size {args.batch_size} x {world} ranks exceeds the "
            f"{len(dataset)}-sample dataset (drop_last): no full batch to "
            "train on")

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = TransformerLM(vocab=vocab, dim=args.dim, n_layers=args.n_layers,
                          n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
                          pos=args.pos, tie_embeddings=args.tie_embeddings,
                          max_seq=args.seq_len,
                          attn_fn=make_flash_attn_fn() if args.flash
                          else None,
                          remat=args.remat, dtype=dtype, device=device,
                          generator=default_generator(device, 0))
    if init_params is not None:
        from_jax_params(init_params, model)
    # at world > 1 its wrapper broadcasts rank 0's weights; the steps run
    # on the model itself (make_train_step averages the gradients)
    dist.prepare_ddp_model(model)
    optimizer = _optimizer(args)
    opt_state = optimizer.init(model.parameters())

    record: Dict[str, Any] = {"rank": dist.get_rank(), "world_size": world,
                              "device": str(device), "losses": [],
                              "start_step": 0}
    start_step = 0
    ckpt_mgr = None
    if args.resume and not args.save:
        raise ValueError("--resume requires --save DIR")

    def resume():
        """Restore the latest checkpoint into the model and its state
        (in place; under a sharded layout each rank its own region)."""
        nonlocal opt_state, start_step
        t0 = time.perf_counter()
        ck = restore_checkpoint(args.save, like_params=model,
                                like_opt_state=opt_state)
        record["restore_s"] = time.perf_counter() - t0
        opt_state = ck.opt_state
        start_step = ck.step + 1
        record["start_step"] = start_step
        if not quiet:
            dist.print_primary(f"resumed from step {ck.step} "
                               f"({args.save})")

    if args.save:
        from distributed_pytorch_tpu_torch.utils.checkpoint import (
            CheckpointManager, restore_checkpoint)
        if args.sharded_ckpt:
            # the checkpoint follows the sharding: the spec tree of the
            # ZeRO layout decomposes the state into owned shards, and a
            # restore reshards onto whatever world this run has
            p_specs, _, ax = fsdp.shard_layouts(model, None,
                                                n_shards=max(world, 1))
            ckpt_mgr = CheckpointManager(
                args.save, interval=args.save_every, keep=3,
                async_save=True, sharded=True, param_specs=p_specs,
                axis_sizes=ax)
        else:
            ckpt_mgr = CheckpointManager(args.save,
                                         interval=args.save_every,
                                         keep=3, async_save=True)
        if args.resume and not args.sharded_ckpt:
            resume()

    if args.fused_ce:
        def per_example(m, x, y):
            # per-token nll is unavailable by design (the full logits
            # never exist): the local batch mean stands for each example
            hid = m(x, return_hidden=True)
            loss = fused_linear_cross_entropy(hid, m.head_weight(), y)
            return loss.expand(x.shape[0])
    else:
        def per_example(m, x, y):
            return cross_entropy_per_example(m(x), y)

    def loss_fn(m, batch):
        x, y = batch
        nll = per_example(m, x, y)
        return nll.mean(), {"nll": nll}

    # the ZeRO-3 layout only across ranks: at world 1 --fsdp is the plain
    # step, as in the JAX example
    use_fsdp = args.fsdp and is_distributed
    if use_fsdp:
        mesh = context.get_mesh()
        specs = fsdp.fsdp_param_specs(model, world)
        model, opt_state = fsdp.shard_model_and_opt(model, opt_state, mesh,
                                                    specs)
        step_fn = fsdp.make_fsdp_train_step(loss_fn, optimizer, mesh, specs)
    else:
        step_fn = make_train_step(loss_fn, optimizer)
    if args.resume and args.sharded_ckpt:
        # into this run's layout: under --fsdp each rank fills its local
        # shards, reading only the saved shards that overlap them
        resume()
    record["fsdp"] = use_fsdp
    logger = MetricsLogger(args.log)

    def save(at, extra, force=False):
        """Stage a checkpoint of step ``at`` if due (or ``force``): the
        model and its state, or under --fsdp their gathered trees (a
        collective of every rank)."""
        if not (force or ckpt_mgr.should_save(at)):
            return False
        params, state = ((fsdp.gather_state(model, opt_state))
                         if use_fsdp and not args.sharded_ckpt
                         else (model, opt_state))
        return ckpt_mgr.save(at, params, state, extra=extra, force=force)
    tokens_per_step = world * args.batch_size * args.seq_len

    def to_device(batch):
        return map_tensors(lambda t: t.to(device, non_blocking=True), batch)

    # the loop reads the device only every --log-every steps: the losses
    # of the steps in between stay device scalars until then
    pending: List = []

    def sync_pending():
        if not pending:
            return None
        losses = torch.cat([loss for _, loss in pending])
        if world > 1:
            losses = dist.all_reduce(losses, "avg")
        values = losses.tolist()
        for (s, _), loss in zip(pending, values):
            record["losses"].append(loss)
            if history is not None:
                history.append(loss)
            logger.log(s, loss=loss)
        pending.clear()
        return values[-1]

    step = start_step
    # a resume lands mid-epoch: restart that epoch's seeded stream at the
    # right batch (skipped at the index level by loader.iter_from)
    epoch = step // len(loader)
    skip = step % len(loader)
    last_saved = None
    t_run0 = None
    trace_t0 = None
    data_s, data_batches = 0.0, 0
    worker_s, worker_batches = 0.0, 0
    save_s: List[float] = []
    # the run's end as one metrics snapshot, for a supervisor reading its
    # elastic child or a monitor reading DPX_METRICS_LOG
    report_end = elastic.is_elastic() or _env.is_set("DPX_METRICS_LOG")
    first_step_wall = None
    while step < args.steps:
        loader.set_epoch(epoch)
        if args.prefetch > 0:
            it = device_prefetch(loader.iter_from(skip),
                                 size=args.prefetch, place=device)
        else:
            it = map(to_device, loader.iter_from(skip))
        try:
            while step < args.steps:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
                data_s += time.perf_counter() - t0
                data_batches += 1
                if args.trace and step == min(5, args.steps - 1):
                    profiler.start_trace(args.trace)
                    trace_t0 = (time.perf_counter(), step)
                out = step_fn(model, opt_state, batch)
                opt_state = out.opt_state
                pending.append((step, out.loss))
                if report_end and first_step_wall is None:
                    profiler.block_until_ready(out.loss)
                    first_step_wall = wall_now()
                if trace_t0 is not None and (step >= 10
                                             or step == args.steps - 1):
                    profiler.block_until_ready(out.loss)
                    record["trace_path"] = profiler.stop_trace()
                    record["trace_steps"] = step + 1 - trace_t0[1]
                    record["trace_wall_s"] = time.perf_counter() - trace_t0[0]
                    trace_t0 = None
                if step % args.log_every == 0 or step == args.steps - 1:
                    loss = sync_pending()
                    if t_run0 is None and step >= 1:
                        t_run0 = (time.perf_counter(), step)
                    if not quiet:
                        dist.print_primary(
                            f"step {step:>5}  loss {loss:.4f}")
                if ckpt_mgr is not None:
                    t0 = time.perf_counter()
                    if save(step, {"epoch": epoch}):
                        last_saved = step
                        save_s.append(time.perf_counter() - t0)
                step += 1
        finally:
            # breaking at --steps must stop the prefetch worker and free
            # its queued device batches before eval/generate allocate
            if hasattr(it, "close"):
                worker_s += it.host_s
                worker_batches += it.batches
                it.close()
        epoch += 1
        skip = 0
    sync_pending()
    profiler.block_until_ready(list(model.parameters()))
    if ckpt_mgr is not None:
        if step > start_step and last_saved != step - 1:
            t0 = time.perf_counter()
            save(step - 1, {"epoch": (step - 1) // len(loader)},
                 force=True)
            save_s.append(time.perf_counter() - t0)
        ckpt_mgr.wait()
        record["ckpt_saves"] = ckpt_mgr.saves
        record["save_call_s"] = save_s

    record["data_ms_per_batch"] = (1e3 * data_s / data_batches
                                   if data_batches else None)
    record["prefetch_worker_ms_per_batch"] = (
        1e3 * worker_s / worker_batches if worker_batches else None)
    if t_run0 is not None and step - t_run0[1] > 0:
        dt = time.perf_counter() - t_run0[0]
        timed_steps = step - t_run0[1]
        sps = timed_steps / dt
        record.update(timed_s=dt, timed_steps=timed_steps)
        if not quiet:
            dist.print_primary(
                f"done: {sps:.2f} steps/s, {sps * tokens_per_step:,.0f} "
                f"tokens/s (mean step {1e3 / sps:.2f} ms, "
                f"{timed_steps} timed steps)")

    if eval_set is not None:
        eval_sampler = dist.data_sampler(eval_set, is_distributed,
                                         shuffle=False)
        eval_loader = DataLoader(eval_set, batch_size=args.batch_size,
                                 sampler=eval_sampler, drop_last=True)
        if len(eval_loader) == 0:
            dist.print_primary("eval: holdout smaller than one global "
                               "batch; skipping")
        else:
            ev = make_eval_step(lambda m, b: per_example(m, *b))
            nlls = [ev(model, to_device(b)).reshape(-1).float().cpu()
                    .numpy() for b in eval_loader]
            nll = float(np.concatenate(nlls).mean())
            record.update(eval_nll=nll, eval_batches=len(eval_loader))
            logger.log(step, eval_nll=nll)
            if not quiet:
                dist.print_primary(
                    f"eval: nll {nll:.4f}  ppl {np.exp(min(nll, 20)):.2f}")

    if args.generate > 0:
        x0, _ = dataset[0]
        p_len = max(1, min(16, args.seq_len, model.max_seq - args.generate))
        prompt = np.asarray(x0)[:p_len][None]
        # under --fsdp the decode reads the whole parameters
        with fsdp.gathered(model):
            toks = make_generate_fn(model, args.generate)(prompt)[0].cpu()
        record["generated"] = toks.tolist()
        if not quiet:
            if args.text:
                dist.print_primary("generated:", bytes(toks.tolist()).decode(
                    errors="replace"))
            else:
                dist.print_primary("generated tokens:", toks.tolist())

    if report_end:
        dpxmon.set_gauge("train.start_step", start_step)
        dpxmon.set_gauge("train.end_step", step)
        if first_step_wall is not None:
            dpxmon.set_gauge("train.first_step_wall", first_step_wall)
        dpxmon.set_gauge("train.eval_batches",
                         record.get("eval_batches", 0))
        for name, n in flash_attention.LAUNCHES.items():
            dpxmon.set_gauge(f"kernels.{name}.launches", n)
        if dist.is_primary():
            dpxmon.emit_snapshot(step=step - 1, source="train_end")
    if out_dir is not None:
        torch.save(record, os.path.join(out_dir, f"rank{rank}.pt"))
    logger.close()
    dist.cleanup()
    return record


def _run(argv, args) -> None:
    if args.nprocs is not None:
        dist.launch_multiprocess(main_worker, args.nprocs, argv,
                                 device=args.device)
    elif args.device == "cpu":
        main_worker(0, 0, argv)
    else:
        dist.launch(main_worker, argv)


def _elastic_entry(argv) -> None:
    """The elastic child: the run itself, resuming whenever the save
    directory already holds a checkpoint (the relaunch after a crash
    must neither start from step 0 nor need ``--resume`` typed)."""
    argv = list(argv)
    args = parse_args(argv)
    if latest_step(args.save) is not None and "--resume" not in argv:
        argv.append("--resume")
        args = parse_args(argv)
    _run(argv, args)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if not args.elastic:
        _run(argv, args)
        return
    if not args.save:
        raise SystemExit("--elastic requires --save DIR")
    res = elastic.elastic_run(_elastic_entry, (argv,),
                              max_restarts=args.elastic)
    if res.restarts:
        print(f"finished after {res.restarts} relaunch(es)")


if __name__ == "__main__":
    main()
