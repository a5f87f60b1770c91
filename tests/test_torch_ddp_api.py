"""The helper API of the PyTorch port against the reference semantics.

The collectives are held to the shared ``canonical(world)`` oracle of
``tests/test_front_door_contract.py`` (which every door of the JAX
package is held to) at world 1 in this process and at world 2 over
gloo, with CPU ranks spawned from the port's own
``examples/collectives.py``. The reference's quirks are cases of their
own: ``reduce`` leaves rank 1's buffer alone, ``gather`` gives rank 1
zeros, an invalid op raises, ``launch`` takes the world-0/1/N branches,
and ``prepare_ddp_model`` wraps iff world > 1, broadcasting rank 0's
weights. An integer ``avg`` keeps its dtype and truncates, as the JAX
host door does, and ``MetricsLogger`` writes ``log`` lines on the
primary only and ``event`` lines on every rank. All comparisons are
exact.
"""

import json
import multiprocessing as mp
import time

import pytest
import torch

import _torch_host_workers as hw
import distributed_pytorch_tpu_torch as tdist_api
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu_torch.examples import collectives
from distributed_pytorch_tpu_torch.models import DummyModel
from distributed_pytorch_tpu_torch.runtime import context, launcher
from distributed_pytorch_tpu_torch.runtime import multiprocess as tmp_mod
from distributed_pytorch_tpu_torch.runtime.watchdog import (ProcessSupervisor,
                                                            WorkerFailure)
from test_front_door_contract import canonical, rank_tensor


def _read(out_dir, rank):
    with open(out_dir / f"rank{rank}.json") as f:
        return json.load(f)


def _as_canonical(obs):
    """The oracle's keys from one rank's observations."""
    return {"all_reduce_sum": obs["all_reduce_sum"],
            "all_reduce_avg": obs["all_reduce_avg"],
            "reduce_root": obs["reduce"], "gather": obs["gather"],
            "broadcast_src1": obs["broadcast_src1"],
            "invalid_op_raises": obs["invalid_op_raises"]}


def _metrics(out_dir):
    with open(out_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def world2_dir(tmp_path_factory):
    """The output directory of one 2-rank gloo run."""
    out = tmp_path_factory.mktemp("collectives_w2")
    launch_cpu_ranks(collectives.main_worker, 2, str(out), "cpu")
    return out


@pytest.fixture(scope="module")
def world2(world2_dir):
    """Both ranks' observations of that run."""
    return [_read(world2_dir, r) for r in range(2)]


@pytest.mark.parametrize("world", [0, 1])
def test_world1_matches_canonical(world, tmp_path):
    """In this process, no group: the world-0 (CPU) and world-1 branches
    both see world 1, where each collective is the identity."""
    collectives.main_worker(0, world, str(tmp_path), "cpu")
    obs = _read(tmp_path, 0)
    assert _as_canonical(obs) == canonical(1)
    assert obs["world_size"] == 1 and obs["rank"] == 0
    assert not obs["initialized"] and obs["backend"] is None
    assert obs["all_gather"] == [rank_tensor(0).tolist()]
    assert obs["reduce_returns_its_input"]
    assert not obs["prepare_ddp_model_wraps"]
    assert obs["params_after"] == obs["params_before"]
    assert obs["all_reduce_avg_int64"] == [3, 4]
    lines = _metrics(tmp_path)
    assert [m.get("step") for m in lines] == [0, 1, None]
    assert lines[2]["event"] == "rank_done" and lines[2]["rank"] == 0


def test_world2_gloo_matches_canonical(world2):
    assert _as_canonical(world2[0]) == canonical(2)
    for r, obs in enumerate(world2):
        assert obs["rank"] == r and obs["world_size"] == 2
        assert obs["initialized"] and obs["backend"] == "gloo"
        assert obs["get_device"] == "cpu"
        assert obs["is_primary"] == (r == 0)
        assert obs["output_devices"] == ["cpu"]
        assert obs["output_dtypes"] == ["torch.float32"]


def test_world2_every_rank_agrees_on_the_all_collectives(world2):
    want = canonical(2)
    for obs in world2:
        assert obs["all_reduce_sum"] == want["all_reduce_sum"]
        assert obs["all_reduce_avg"] == want["all_reduce_avg"]
        assert obs["broadcast_src1"] == want["broadcast_src1"]
        assert obs["all_gather"] == want["gather"]
        assert obs["all_reduce_max"] == rank_tensor(1).tolist()
        assert obs["all_reduce_min"] == rank_tensor(0).tolist()
        assert obs["sync_params"] == rank_tensor(0).tolist()
        assert obs["replicate"] == rank_tensor(0).tolist()
        assert obs["shard_batch"] == rank_tensor(obs["rank"]).tolist()


def test_integer_avg_truncates_at_world2(world2):
    """Rank inputs [3, 4] and [6, 8]: the sum [9, 12] over 2 is [4.5, 6],
    truncated to [4, 6] in int64 (the JAX host door's float64 mean cast
    back)."""
    for obs in world2:
        assert obs["all_reduce_avg_int64"] == [4, 6]
        assert obs["all_reduce_avg_int64_dtype"] == "torch.int64"


def test_metrics_logger_logs_on_the_primary_and_events_on_every_rank(
        world2_dir):
    lines = _metrics(world2_dir)
    logs = [m for m in lines if "step" in m]
    events = [m for m in lines if "event" in m]
    assert [m["step"] for m in logs] == [0, 1]
    assert [m["loss"] for m in logs] == [0.0, 1.0]
    assert sorted(m["rank"] for m in events) == [0, 1]
    assert all(m["event"] == "rank_done" for m in events)


def test_reduce_leaves_rank1_buffer_untouched(world2):
    assert world2[1]["reduce"] == rank_tensor(1).tolist()
    assert world2[1]["reduce_returns_its_input"]
    assert world2[0]["reduce_returns_its_input"]


def test_gather_returns_zeros_on_rank1(world2):
    assert world2[1]["gather"] == [[0.0, 0.0, 0.0]] * 2


def test_invalid_op_raises_at_world2(world2):
    assert all(obs["invalid_op_raises"] for obs in world2)


def test_data_parallel_broadcasts_rank0_weights(world2):
    r0, r1 = world2
    assert r0["prepare_ddp_model_wraps"] and r1["prepare_ddp_model_wraps"]
    assert r0["params_before"] != r1["params_before"]
    assert r0["params_after"] == r1["params_after"] == r0["params_before"]


@pytest.mark.parametrize("count", [0, 1, 3])
def test_launch_branches(count, monkeypatch):
    calls, spawned = [], []
    monkeypatch.setattr(context, "device_count", lambda: count)
    monkeypatch.setattr(tmp_mod, "launch_multiprocess",
                        lambda fn, n, *a: spawned.append((fn, n, a)))

    def worker(rank, world, *args):
        calls.append((rank, world, args))

    launcher.launch(worker, "x")
    if count > 1:
        assert calls == [] and spawned == [(worker, count, ("x",))]
    else:
        assert calls == [(0, count, ("x",))] and spawned == []


def test_prepare_ddp_model_returns_same_object_at_world1():
    model = DummyModel(device="cpu")
    assert tdist_api.prepare_ddp_model(model, device_ids=[0]) is model


def test_api_exports_the_reference_functions():
    names = ["find_free_port", "launch", "init_process_group",
             "is_dist_avail_and_initialized", "cleanup", "get_rank",
             "get_device", "is_primary", "get_world_size", "data_sampler",
             "prepare_ddp_model", "all_reduce", "reduce", "gather",
             "sync_params", "barrier", "wait_for_everyone", "print_primary"]
    assert all(callable(getattr(tdist_api, n)) for n in names)
    assert tdist_api.get_rank() == 0 and tdist_api.get_world_size() == 1
    assert not tdist_api.is_dist_avail_and_initialized()
    assert tdist_api.is_primary() and tdist_api.get_backend() is None
    tdist_api.cleanup()          # a no-op outside a group


def test_no_silent_fallback_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist_api.get_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist_api.launch_multiprocess(collectives.main_worker, 2, "x")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist_api.init_process_group(0, 2)
    with pytest.raises(ValueError, match="invalid reduce operation"):
        tdist_api.all_reduce(torch.ones(2), "prod")


def test_a_failing_rank_raises_its_traceback(tmp_path, monkeypatch):
    """Both ranks fail writing into a directory that does not exist:
    the parent raises WorkerFailure carrying a rank's traceback, and
    appends a ``worker_failure`` event naming it to
    ``DPX_METRICS_LOG``."""
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("DPX_METRICS_LOG", str(log))
    with pytest.raises(WorkerFailure, match="FileNotFoundError") as info:
        launch_cpu_ranks(collectives.main_worker, 2,
                         str(tmp_path / "missing"), "cpu")
    assert info.value.rank in (0, 1) and info.value.exitcode == 1
    # (a launch retried on a taken port logs its first failure too)
    last = json.loads(log.read_text().splitlines()[-1])
    assert (last["event"], last["rank"], last["exitcode"], last["world"]) \
        == ("worker_failure", info.value.rank, 1, 2)


def test_the_host_backend_keeps_the_card_default(monkeypatch):
    """``DPX_BACKEND=host`` changes the group, not the device: a rank
    still asks for ``cuda:r`` unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.delenv("DPX_MULTIPROC_ACCEL", raising=False)
    monkeypatch.setenv("DPX_BACKEND", "host")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist_api.launch_multiprocess(collectives.main_worker, 2, "x")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist_api.launch_multiprocess(collectives.main_worker, 2, "x",
                                      backend="host")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist_api.init_process_group(0, 1)
    assert not tdist_api.is_dist_avail_and_initialized()


@pytest.mark.parametrize("backend", ["gloo", "host"])
def test_a_failing_rank_exits_1_under_each_backend(tmp_path, backend):
    """The same failure under each backend: every failing rank leaves
    with exit code 1 (its group torn down before it exits), never a
    signal, and the parent raises a rank's traceback."""
    with pytest.raises(WorkerFailure, match="FileNotFoundError") as info:
        launch_cpu_ranks(collectives.main_worker, 2,
                         str(tmp_path / "missing"), "cpu",
                         backend="host" if backend == "host" else None)
    assert info.value.rank in (0, 1) and info.value.exitcode == 1
    assert (info.value.op, info.value.kind) == (None, None)


@pytest.mark.parametrize("backend", ["gloo", "host"])
def test_a_rank_that_exits_0_ends_cleanly(tmp_path, backend):
    """``sys.exit(0)`` and ``sys.exit()`` in a rank are clean exits under
    each backend: the launch returns, and each rank got as far as its
    exit."""
    launch_cpu_ranks(hw.clean_exit_worker, 2, str(tmp_path),
                     backend="host" if backend == "host" else None)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rank0.json",
                                                          "rank1.json"]


def test_supervisor_deadline_terminates_a_hung_rank():
    proc = mp.get_context("spawn").Process(target=time.sleep, args=(120,))
    proc.start()
    t0 = time.monotonic()
    with pytest.raises(WorkerFailure, match="still running") as info:
        ProcessSupervisor([proc], grace_s=2.0).join(timeout_s=1.0)
    assert info.value.rank == 0 and info.value.exitcode is None
    assert time.monotonic() - t0 < 30
    proc.join(10)
    assert not proc.is_alive()
