"""What the command loads: nothing of the JAX stack or the JAX package
(top-level names compared whole), the reference nothing of the program,
no file under ``benchmarks/``; and no result without a card."""

import ast
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from portbench import harness
from portbench.drivers import ddp_train
from portbench.tests import tiny

PB = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "distributed_pytorch_tpu"}
PORT = "distributed_pytorch_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    return [p for p in PB.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_the_jax_stack_or_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
        text = path.read_text()
        assert "benchmarks/" not in text, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top in ("torch", "math", "typing", "__future__"), (path,
                                                                      mod)


def test_a_run_loads_nothing_forbidden(tmp_path):
    """A whole tiny run in a fresh interpreter, then every loaded
    module's top-level name."""
    code = f"""
import sys, time, json
from pathlib import Path
sys.path.insert(0, {str(harness.ROOT)!r})
from portbench import harness
from portbench.tests import tiny
root = tiny.make_root(Path({str(tmp_path)!r}))
bench = harness.load_benchmark(root / "BENCHMARK.json")
for cell in ("tiny.train", "tiny.serve"):
    harness.run_cell(bench, cell, 5, 0.5, True, "cpu", time.perf_counter(),
                     root=root)
ref = sorted(m for m in sys.modules if m.startswith("portbench.reference"))
print(json.dumps([sorted({{m.split(".")[0] for m in sys.modules}}), ref]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops, ref = json.loads(out.stdout.strip().splitlines()[-1])
    assert PORT in tops and "portbench" in tops
    assert not set(tops) & FORBIDDEN
    assert ref


def jax_loading_rank(rank, world, spec, out_dir):
    """A rank that has a module named ``jax`` loaded by its window's end."""
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    ddp_train.rank_main(rank, world, spec, out_dir)


@pytest.mark.parametrize("entry", [None, jax_loading_rank])
def test_each_rank_is_checked_for_forbidden_modules(tmp_path, monkeypatch,
                                                    entry):
    """The data-parallel ranks run the window in processes of their own:
    a world-2 run over gloo gives a result only where no rank loaded a
    forbidden module."""
    root = tiny.make_root(tmp_path)
    bench = harness.load_benchmark(root / "BENCHMARK.json")
    harness.find(bench["workloads"], "tiny.ddp", "workload")["chips"] = 2
    if entry is not None:
        monkeypatch.setattr(ddp_train, "RANK_MAIN", entry)

    def run():
        return harness.run_cell(bench, "tiny.ddp", 2 ** 31 + 17, 0.5, False,
                                "cpu", time.perf_counter(), root=root)
    if entry is None:
        res = run()
        assert res["correct"] and res["device"]["count"] == 2
    else:
        with pytest.raises(harness.ForbiddenLoaded, match="jax"):
            run()


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.gpt2; "
            f"print(sorted(m for m in sys.modules if m.startswith({PORT!r})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints
    nothing on standard output (decided at run time, so it is checked
    only where there is no card)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the command would run the cell")
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "gpt2-small.train", "--seed",
                          str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
