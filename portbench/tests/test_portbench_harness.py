"""The harness: discovery by name, the result line's shape, and
BENCHMARK.json against the contract's limits."""

import io
import json
import re
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from portbench import harness
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def bench(root):
    return harness.load_benchmark(root / "BENCHMARK.json")


def _run(bench, root, cell, trace, seed=2 ** 31 + 11):
    return harness.run_cell(bench, cell, seed, 1.0, trace, "cpu",
                            time.perf_counter(), root=root)


def test_pieces_added_as_files_only_are_found(root, bench, tmp_path):
    """A configuration, a mix, a limits file, a metric reader and a cell
    that exist only as new files and entries are found by name."""
    new = tmp_path / "bench"
    tiny.make_root(new)
    tiny.write(new / "portbench" / "configs" / "tiny2.json",
               dict(tiny.TINY, n_layer=1))
    tiny.write(new / "portbench" / "mixes" / "tiny_train_b2.json",
               dict(tiny.TRAIN_MIX, batch=2))
    tiny.write(new / "portbench" / "limits" / "tiny2.train.json",
               tiny.LIMITS["tiny.train"])
    (new / "portbench" / "metrics" / "steps_in_window.train.py").write_text(
        "def read(ctx, trace):\n    return ctx.get('steps')\n")
    b = harness.load_benchmark(new / "BENCHMARK.json")
    b["configs"].append({"name": "tiny2", "source": "test",
                         "file": "portbench/configs/tiny2.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny2.train", "config": "tiny2",
                           "traffic": "tiny_train_b2", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "steps_in_window.train", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "train step",
                           "moves": "train_tokens_per_s",
                           "workloads": ["tiny2.train"]})
    tiny.write(new / "BENCHMARK.json", b)
    b = harness.load_benchmark(new / "BENCHMARK.json")
    cell, config, mix, limits = harness.cell_pieces(b, "tiny2.train", new)
    assert config["n_layer"] == 1 and mix["batch"] == 2
    assert "steps_in_window.train" in [
        m["name"] for m in harness.metrics_for(b, "tiny2.train", True)]
    res = _run(b, new, "tiny2.train", True)
    assert res["metrics"]["steps_in_window.train"]["value"] == \
        res["attempted"]
    # the other cells do not report the new metric
    assert "steps_in_window.train" not in [
        m["name"] for m in harness.metrics_for(b, "tiny.train", True)]


@pytest.mark.parametrize("metric, file", [
    ("gemm_ms_per_step.train", "gemm_ms_per_step.py"),
    ("gemm_ms_per_step.ddp", "gemm_ms_per_step.py"),
    ("train_mfu.ddp", "train_mfu.py"),
    ("train_mfu", "train_mfu.py"),
    ("serve_ttft_p95_ms", "serve_ttft_p95_ms.py"),
    ("gemm_ms_per_step.own", "gemm_ms_per_step.own.py")])
def test_a_split_metric_reads_its_quantitys_reader(tmp_path, metric, file):
    """A metric split by the rate it moves is read by the reader of its
    quantity, unless a reader of its own name is there."""
    root = tiny.make_root(tmp_path)
    (root / "portbench" / "metrics" / "gemm_ms_per_step.own.py").write_text(
        "def read(ctx, trace):\n    return 1.0\n")
    path = harness.reader_path(metric, root)
    assert path == root / "portbench" / "metrics" / file and path.is_file()


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line(root, bench, cell, trace):
    res = _run(bench, root, cell, trace)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.emit(res)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = list(last)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
    assert keys[-1] == "checks"
    assert isinstance(last["correct"], bool) and last["correct"]
    assert last["attempted"] > 0 and last["failed"] == 0
    dev = last["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    wanted = {m["name"] for m in harness.metrics_for(bench, cell, trace)}
    assert set(last["metrics"]) <= wanted
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in last["breakdown"].values())
    else:
        assert "setup_s" in last["metrics"]
    for name, c in last["checks"].items():
        assert set(c) == {"value", "limit"}
    lines = err.getvalue().strip().splitlines()
    assert lines[-1] == "correct: True"
    assert lines[-1 - len(last["checks"]):-1] == [
        f"check {n}: {c['value']!r} limit {c['limit']!r}"
        for n, c in last["checks"].items()]


def test_benchmark_json_keeps_the_contract():
    b = harness.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(not p.startswith("/") and ".." not in p for p in b["paths"])
    root = harness.ROOT
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (root / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank")) and "n_embd" not in k
    used = set()
    four = 0
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        four += w["chips"] == 4
        assert w["config"] in {c["name"] for c in b["configs"]}
        pb = root / "portbench"
        assert (pb / "limits" / f"{w['name']}.json").is_file()
        mix = json.loads((pb / "mixes" / f"{w['traffic']}.json").read_text())
        assert (pb / "drivers" / f"{mix['driver']}.py").is_file()
        used.add(w["config"])
        e2e = harness.metrics_for(b, w["name"], False)
        per = harness.metrics_for(b, w["name"], True)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per
        assert {m["moves"] for m in per} <= {m["name"] for m in e2e}
    assert four <= max(1, len(b["workloads"]) // 4)
    assert used == {c["name"] for c in b["configs"]}
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == \
        len(b["workloads"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in b["per_layer"]:
        assert harness.reader_path(m["name"], root).is_file()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024
