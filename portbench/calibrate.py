"""Readings that the limits of ``correct`` are set from, at a cell's own
size: the program on many seeds, the control and the planted faults on
a few. Not run by the benchmark's runs.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 8 --out chiprun_out/cal.json

Training cells: each program seed drives the cell's train object
through its checked steps and is held against the float32 reference.
On each control seed the reference itself stands in for the program,
computed in fp8 (``reference.gpt2.fp8_mm``), again with half of each
batch left out and the mean taken over the rest, and again with its
state left unchanged (lr and decay 0: its losses; its change reads 1
by the measure and needs no run). At world > 1 the program's readings
come from the cell's own runs, and a further stand-in steps each rank
on its own gradient: the exchange between chips left out. Serving
cells: each seed is a run of the cell with a short window; on each
control seed the same served requests are judged at the tokens an fp8
forward ranks first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

from . import checks, harness
from .drivers import serve_closed, train
from .reference import gpt2 as ref


def _as_rank(readings: dict, k: int = 0) -> dict:
    """The reference's readings as rank ``k``'s: its loss at each step."""
    return dict(readings, losses=[s[k] for s in readings["losses"]])


def _ranks(readings: dict) -> list:
    """The reference standing in for every rank of a data-parallel run:
    one shared state, each rank's own losses."""
    return [_as_rank(readings, k) for k in range(len(readings["losses"][0]))]


def train_cell(bench, cell, seeds, control_seeds, device, root):
    cell_d, config, mix, _ = harness.cell_pieces(bench, cell, root)
    out = {"program": {}, "fp8": {}, "half_batch": {}, "frozen": {},
           "raw": {}}

    def run_of(seed):
        return harness.Run(cell=cell_d, config=config, mix=mix,
                           seed=seed, seconds=0, trace=False,
                           device=device, t_start=time.perf_counter())
    world = cell_d["chips"] if mix["driver"] == "ddp_train" else 1
    refs = {}
    # at world > 1 the program's readings come from the cell's own runs
    for seed in (seeds if world == 1 else []):
        r = run_of(seed)
        tr = train.Trainer(r)
        prog = tr.checked_steps(mix["checked_steps"])
        tr.free()
        refs[seed] = train.reference_readings(r)
        out["program"][seed] = checks.train_numbers([prog], refs[seed])
        out["raw"][seed] = {"program_losses": prog["losses"],
                            "reference_losses": refs[seed]["losses"]}
        print(cell, "program", seed, out["program"][seed], flush=True)
    for seed in control_seeds:
        r = run_of(seed)
        base = refs.get(seed) or train.reference_readings(r, world=world)
        fp8 = train.reference_readings(r, mm=ref.fp8_mm, world=world)
        out["fp8"][seed] = checks.train_numbers(_ranks(fp8), base)
        half = train.reference_readings(r, first=mix["batch"] // 2,
                                        world=world)
        out["half_batch"][seed] = checks.train_numbers(_ranks(half), base)
        if world > 1:
            # the exchange left out: each rank steps on its own gradient
            alone = [_as_rank(train.reference_readings(
                r, world=world, ranks=[k])) for k in range(world)]
            out.setdefault("no_exchange", {})[seed] = checks.train_numbers(
                alone, base)
            print(cell, "no_exchange", seed, out["no_exchange"][seed],
                  flush=True)
        still = dict(config, assumed=dict(config["assumed"], train=dict(
            config["assumed"]["train"], adamw=dict(
                config["assumed"]["train"]["adamw"], lr=0.0,
                weight_decay=0.0))))
        frozen = train.reference_readings(dataclasses.replace(r,
                                                              config=still),
                                          world=world)
        # a state left unchanged: its loss readings; its change reads 1
        # and its first gradient is the reference's own
        out["frozen"][seed] = checks.train_numbers(_ranks(frozen), base)
        out["raw"].setdefault(seed, {"reference_losses": base["losses"]})
        out["raw"][seed].update(fp8_losses=fp8["losses"],
                                half_losses=half["losses"],
                                frozen_losses=frozen["losses"])
        print(cell, "fp8", seed, out["fp8"][seed], "half",
              out["half_batch"][seed], "frozen", out["frozen"][seed],
              flush=True)
    return out


def serve_cell(bench, cell, seeds, control_seeds, seconds, device, root):
    import torch
    cell_d, config, mix, _ = harness.cell_pieces(bench, cell, root)
    out = {"program": {}, "fp8": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        r = harness.Run(cell=cell_d, config=config, mix=mix, seed=seed,
                        seconds=seconds, trace=False, device=device,
                        t_start=time.perf_counter())
        o = serve_closed.run(r)
        recs = o.context["sample"]
        if seed in seeds:
            out["program"][seed] = dict(o.numbers, attempted=o.attempted,
                                        failed=o.failed,
                                        sampled_tokens=sum(x["n_out"]
                                                           for x in recs))
            print(cell, "program", seed, out["program"][seed], flush=True)
        out.setdefault("raw", {})[seed] = {"program": serve_closed.served(
            config, recs, seed, torch.device(device))}
        if seed in control_seeds:
            gaps = serve_closed.served(config, recs, seed,
                                       torch.device(device),
                                       pick_mm=ref.fp8_mm)
            out["fp8"][seed] = checks.serve_numbers(gaps)
            out["raw"][seed]["fp8"] = gaps
            print(cell, "fp8", seed, out["fp8"][seed], flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(harness.ROOT))
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    root = Path(a.root)
    bench = harness.load_benchmark(root / "BENCHMARK.json")
    seeds = [int(s) for s in a.seeds.split(",")]
    control = [int(s) for s in a.control_seeds.split(",")]
    cell = harness.find(bench["workloads"], a.workload, "workload")
    mix = harness.load_json(root / "portbench" / "mixes"
                            / f"{cell['traffic']}.json")
    t = time.perf_counter()
    if mix["driver"] == "serve_closed":
        res = serve_cell(bench, a.workload, seeds, control, a.seconds,
                         a.device, root)
    else:
        res = train_cell(bench, a.workload, seeds, control, a.device, root)
    res["seconds"] = time.perf_counter() - t
    if a.device == "cuda":
        import torch
        res["device"] = torch.cuda.get_device_name(0)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
