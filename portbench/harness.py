"""The harness: finds every piece of a cell by name, runs it, and prints
the result line.

``BENCHMARK.json`` names the cell; its ``config`` names a configuration
whose ``file`` holds the sizes; its ``traffic`` names
``portbench/mixes/<traffic>.json``, whose ``driver`` names
``portbench/drivers/<driver>.py``; each per-layer metric is read by
``portbench/metrics/<metric>.py``, or by the reader of the quantity it
splits (:func:`reader_path`); the limits that decide ``correct``
are ``portbench/limits/<cell>.json``. A later change adds a cell, a
configuration, a mix or a metric by adding files and entries only.

A driver's ``run(run)`` returns a :class:`Outcome`. The harness picks
the cell's end-to-end metrics (``--trace 0``) or asks each per-layer
reader (``--trace 1``), compares the driver's numbers with their
limits, and prints one JSON line, ``checks`` last.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
#: Top-level module names that may not be loaded in the process that
#: prints a result: the JAX stack and the JAX package the port came from.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax",
                               "distributed_pytorch_tpu"})


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell and its pieces, the run's
    arguments, the device and the clock the set-up started on."""
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    chips: int = 1


@dataclasses.dataclass
class Outcome:
    """What a driver returns. ``end_to_end`` holds the host-clock and
    memory readings by metric name; ``context`` is what the per-layer
    readers read; ``numbers`` are the comparisons with the reference by
    limit name; ``memory_peak_bytes`` is read before the reference
    runs."""
    end_to_end: Dict[str, float]
    context: Dict[str, Any]
    numbers: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Any = None            # trace.Summary of the traced window


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_pieces(bench: dict, cell_name: str, root: Path = ROOT):
    """(cell, config, mix, limits) of ``cell_name``."""
    cell = find(bench["workloads"], cell_name, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    config = load_json(root / conf["file"])
    mix = load_json(root / "portbench" / "mixes" / f"{cell['traffic']}.json")
    limits = load_json(root / "portbench" / "limits" / f"{cell_name}.json")
    return cell, config, mix, limits


def driver(name: str):
    """``portbench/drivers/<name>.py``, whose ``run(Run)`` returns an
    :class:`Outcome`."""
    return importlib.import_module(f"portbench.drivers.{name}")


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """``portbench/metrics/<metric>.py``, or, where there is none, the
    reader of the quantity the metric splits by the rate it moves:
    ``gemm_ms_per_step.py`` reads ``gemm_ms_per_step.train`` and
    ``gemm_ms_per_step.ddp``."""
    metrics = root / "portbench" / "metrics"
    own = metrics / f"{metric}.py"
    if own.is_file() or "." not in metric:
        return own
    return metrics / f"{metric.rsplit('.', 1)[0]}.py"


def reader(metric: str, root: Path = ROOT) -> Callable[[dict, Any], Any]:
    """The ``read(context, trace)`` of :func:`reader_path` (loaded by
    path: metric names hold dots)."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    with ``--trace 0``, its per-layer metrics with ``--trace 1``. A
    metric without ``workloads`` belongs to every cell that reports the
    end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def check(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, dict]:
    """Each compared number beside its limit; a number without a limit,
    or a limit without a number, is an error of the harness."""
    if set(numbers) != set(limits):
        raise KeyError(f"numbers {sorted(numbers)} against limits "
                       f"{sorted(limits)}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passes(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             root: Path = ROOT) -> dict:
    """Run one cell and return the result object (not yet printed)."""
    cell, config, mix, limits = cell_pieces(bench, cell_name, root)
    run = Run(cell=cell, config=config, mix=mix, seed=int(seed),
              seconds=float(seconds), trace=bool(trace), device=device,
              t_start=t_start, chips=int(cell["chips"]))
    out: Outcome = driver(mix["driver"]).run(run)
    metrics = {}
    for m in metrics_for(bench, cell_name, trace):
        if trace:
            value = reader(m["name"], root)(out.context, out.trace)
        else:
            value = out.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(f"portbench: {cell_name} seed {seed}: setup "
          f"{out.end_to_end.get('setup_s', float('nan')):.2f} s, window "
          f"{out.context.get('window_s', float('nan')):.2f} s, reference "
          f"{out.context.get('reference_s', float('nan')):.2f} s, "
          f"{out.attempted} attempted", file=sys.stderr)
    if out.context.get("setup_stamps"):
        print(f"portbench: set-up phases, s from the start: "
              f"{out.context['setup_stamps']}", file=sys.stderr)
    if "loss_gaps" in out.context:
        print(f"portbench: loss gaps by step (read, not compared): "
              f"{out.context['loss_gaps']}", file=sys.stderr)
    checks = check(out.numbers, limits)
    result = {"correct": bool(passes(checks) and out.failed == 0
                              and out.attempted > 0),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics,
              "device": device_record(device, run.chips,
                                      out.memory_peak_bytes, out.trace)}
    if trace and out.trace is not None:
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = checks
    return result


def device_record(device: str, chips: int, peak: int, summary) -> dict:
    import torch
    rec = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        rec["busy_s"] = summary.busy_s
        rec["window_s"] = summary.window_s
    return rec


class ForbiddenLoaded(RuntimeError):
    """A process of the run (a data-parallel rank) had modules of the
    JAX stack or package loaded once its window closed."""


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN_MODULES)


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)

