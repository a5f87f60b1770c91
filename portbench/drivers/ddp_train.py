"""Data-parallel training cells: the reference workload's DDP path on
the cell's cards.

This process starts one rank per card through the port's launcher
(``runtime/multiprocess.py`` ``launch_multiprocess``, what ``launch``
does when it sees more than one card). Each rank joins the group
(``init_process_group``: NCCL between cards, gloo between CPU ranks),
builds :class:`.train.Trainer` at world > 1 (``prepare_ddp_model``,
``make_train_step`` with its gradient all-reduce, ``data_sampler``),
drives the checked steps, runs the window, writes its record (with the
forbidden modules it had loaded by then) and ends.
Once every rank has ended this process reads the records and runs the
reference over the global batch, one part per rank, on the first card.

Its rate is ``ddp_tokens_per_s``, apart from the one-card cells'
``train_tokens_per_s``: four ranks on one host spread wider between
runs than one, and a shared bound would blunt the one-card cells'.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path

from .. import checks, program
from ..harness import ForbiddenLoaded, Outcome, Run, forbidden_loaded
from ..trace import Summary
from . import train


def rank_main(rank: int, world: int, spec: dict, out_dir: str) -> None:
    """One rank: the train object, its checked steps and the window;
    its record goes to ``<out_dir>/rank<rank>.json``."""
    import torch
    program.port("api").init_process_group(rank, world)
    r = Run(**spec)
    tr = train.Trainer(r, rank, world)
    on_card = tr.device.type == "cuda"
    readings = tr.checked_steps(r.mix["checked_steps"])
    setup_peak = torch.cuda.max_memory_allocated(tr.device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(tr.device)
    w = train.window(tr, r)
    forbidden = forbidden_loaded()
    peak = torch.cuda.max_memory_allocated(tr.device) if on_card else 0
    tr.free()
    rec = {"rank": rank, "forbidden": forbidden, "readings": readings,
           "t0": w["t0"], "t1": w["t1"],
           "steps": w["steps"], "loader_s": w["loader_s"],
           "nonfinite": w["nonfinite"], "setup_peak": setup_peak,
           "peak": peak, "setup_stamps": tr.stamps,
           "trace": w["trace"].to_record() if w["trace"] else None}
    tmp = Path(out_dir) / f"rank{rank}.json.tmp"
    tmp.write_text(json.dumps(rec))
    os.replace(tmp, Path(out_dir) / f"rank{rank}.json")


#: The entry the launcher starts in each rank, by module path.
RANK_MAIN = rank_main


def run(r: Run) -> Outcome:
    import torch
    world = r.chips
    on_card = r.device == "cuda"
    launcher = program.port("runtime.multiprocess")
    with tempfile.TemporaryDirectory(prefix="portbench-ddp-") as d:
        launcher.launch_multiprocess(
            RANK_MAIN, world, dataclasses.asdict(r), d,
            device=None if on_card else "cpu",
            timeout_s=r.seconds + r.mix["launch_timeout_s"])
        recs = [json.loads((Path(d) / f"rank{i}.json").read_text())
                for i in range(world)]
    found = sorted({m for rec in recs for m in rec["forbidden"]})
    if found:
        raise ForbiddenLoaded(f"{', '.join(found)} (in a rank)")
    steps = {rec["steps"] for rec in recs}
    if len(steps) != 1:
        raise RuntimeError(f"ranks ran different step counts: {steps}")
    t0, t1 = min(x["t0"] for x in recs), max(x["t1"] for x in recs)
    window_s = t1 - t0
    mix = r.mix
    tokens = recs[0]["steps"] * mix["batch"] * mix["seq"] * world
    peak = max(x["peak"] for x in recs)
    end_to_end = {"ddp_tokens_per_s": tokens / window_s,
                  "train_peak_mem_gib": peak / 2 ** 30,
                  "setup_s": t0 - r.t_start}
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    context = train.context_of(r, dict(recs[0], t0=t0, t1=t1), kind, world)
    summary = None
    if recs[0]["trace"] is not None:
        # rank 0's trace, its busy and window seconds the ranks' mean
        summary = Summary.from_record(recs[0]["trace"])
        summary.busy_s = sum(x["trace"]["busy_s"] for x in recs) / world
        summary.window_s = sum(x["trace"]["window_s"] for x in recs) / world
    t_ref = time.perf_counter()
    context["readings"] = [x["readings"] for x in recs]
    context["reference"] = train.reference_readings(r, world=world)
    context["reference_s"] = time.perf_counter() - t_ref
    numbers = checks.train_numbers(context["readings"], context["reference"])
    context["loss_gaps"] = checks.loss_gaps(context["readings"],
                                            context["reference"])
    return Outcome(end_to_end=end_to_end, context=context, numbers=numbers,
                   attempted=recs[0]["steps"],
                   failed=sum(x["nonfinite"] for x in recs),
                   memory_peak_bytes=max(max(x["peak"], x["setup_peak"])
                                         for x in recs),
                   trace=summary)
