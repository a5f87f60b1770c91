"""The port's elastic restart (``runtime/elastic.py``) and the trainer's
``--elastic``.

- A 2-rank gloo worker that checkpoints every step is killed on elastic
  attempt 0 (``kill@step=3,rank=1,attempt=0``): the relaunch resumes
  from step 2's checkpoint, and its losses and final parameters equal
  an uninterrupted run's bit for bit (the reference runs in the same
  ranks after the resumed run, with no hook and no checkpoint).
- Give-up after ``max_restarts``: ``WorkerFailure`` with the last exit
  code, an ``elastic_worker_exit`` per attempt and ``elastic_giveup``.
- An interrupted supervisor terminates and reaps its child.
- ``elastic_attempt`` / ``is_elastic`` outside ``elastic_run``.
- ``examples/train_transformer_lm.py --elastic 1 --save`` at a small CPU
  width with ``adamw8bit``, killed in the second commit's rename window
  (``kill@op=ckpt_commit_window,call=2,attempt=0``): the relaunch
  resumes from the last complete step with the uninterrupted run's
  losses, bit for bit, and the log holds ``fault_injected``,
  ``elastic_worker_exit`` and ``elastic_recovered``. (The plain
  ``adamw`` trainer's elastic run is ``test_torch_train_lm.py``'s
  ``--sharded-ckpt --elastic 1`` case.)

Four process launches (each a spawned child or two). Serial run time
~40 s.
"""

import json
import os
import signal
import threading
import time

import pytest

import _torch_fault_workers as fw
from distributed_pytorch_tpu_torch.examples import train_transformer_lm
from distributed_pytorch_tpu_torch.runtime import elastic, faults
from distributed_pytorch_tpu_torch.runtime.watchdog import WorkerFailure


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("DPX_FAULT", "DPX_ELASTIC_ATTEMPT", "DPX_ELASTIC",
                 "DPX_PLATFORM"):
        monkeypatch.delenv(name, raising=False)
    faults.reset()
    yield
    faults.reset()


def _events(path):
    return [json.loads(x) for x in open(path).read().splitlines()]


def test_killed_rank_relaunches_and_resumes_bit_exact(tmp_path, monkeypatch):
    ck, out = tmp_path / "ck", tmp_path / "out"
    out.mkdir()
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("DPX_METRICS_LOG", str(log))
    monkeypatch.setenv("DPX_TRACE", "1")
    res = elastic.elastic_run(
        fw.elastic_target, (str(ck), str(out)), max_restarts=1,
        backoff_s=0.05,
        env={"DPX_FAULT": "kill@step=3,rank=1,attempt=0"})
    assert res.restarts == 1 and res.exitcodes[-1] == 0
    assert not os.path.exists(out / "rank0_attempt0.json")
    for rank in (0, 1):
        rec = json.loads((out / f"rank{rank}_attempt1.json").read_text())
        assert rec["start"] == 3
        assert rec["losses"] == rec["ref_losses"][3:]
        assert rec["params"] == rec["ref_params"]
    events = _events(log)
    kinds = [e.get("event") for e in events]
    assert kinds.count("worker_failure") == 1
    assert kinds.count("elastic_worker_exit") == 1
    assert kinds.count("elastic_recovered") == 1
    # over gloo the survivor's error is untyped: the supervisor reports
    # the first abnormal exit (the victim's 43, or the survivor's 1)
    failure = next(e for e in events if e.get("event") == "worker_failure")
    assert failure["world"] == 2
    assert failure["exitcode"] in (1, faults.KILL_EXIT_CODE)
    assert res.exitcodes[0] == 1
    assert [(e["rank"], e["action"], e["site"]) for e in events
            if e.get("event") == "fault_injected"] == [(1, "kill", "step=3")]
    # the environment of the child never leaks into the supervisor
    assert "DPX_FAULT" not in os.environ or os.environ["DPX_FAULT"] == ""
    assert not elastic.is_elastic() and elastic.elastic_attempt() == 0


def test_gives_up_after_max_restarts(tmp_path, monkeypatch):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("DPX_METRICS_LOG", str(log))
    with pytest.raises(WorkerFailure, match="failed 2 times") as info:
        elastic.elastic_run(fw.exits_with, (7,), max_restarts=1,
                            backoff_s=0.01,
                            env={"DPX_ELASTIC_TEST_LEAK": "child-only"})
    assert info.value.exitcode == 7
    events = _events(log)
    assert [(e["event"], e.get("attempt"), e.get("exitcode"))
            for e in events] == [("elastic_worker_exit", 0, 7),
                                 ("elastic_worker_exit", 1, 7),
                                 ("elastic_giveup", None, None)]
    assert events[-1]["exitcodes"] == [7, 7]
    assert "DPX_ELASTIC_TEST_LEAK" not in os.environ


def test_interrupted_supervisor_leaks_no_child(tmp_path):
    pid_file = tmp_path / "pid"

    def interrupt(signum, frame):
        raise KeyboardInterrupt

    def alarm_once_started():
        # once the child has recorded its pid, the supervisor (this
        # process's main thread, blocked in the join) gets the signal
        deadline = time.monotonic() + 60
        while not pid_file.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGALRM)

    old = signal.signal(signal.SIGALRM, interrupt)
    try:
        threading.Thread(target=alarm_once_started, name="test-alarm",
                     daemon=True).start()
        with pytest.raises(KeyboardInterrupt):
            elastic.elastic_run(fw.sleeps_long, (str(pid_file),),
                                max_restarts=0, backoff_s=0.0)
    finally:
        signal.signal(signal.SIGALRM, old)
    pid = int(pid_file.read_text())
    with pytest.raises(OSError):
        os.kill(pid, 0)


def test_attempt_helpers_outside_elastic_run(monkeypatch):
    assert elastic.elastic_attempt() == 0 and not elastic.is_elastic()
    monkeypatch.setenv("DPX_ELASTIC_ATTEMPT", "2")
    monkeypatch.setenv("DPX_ELASTIC", "1")
    assert elastic.elastic_attempt() == 2 and elastic.is_elastic()
    monkeypatch.setenv("DPX_ELASTIC_ATTEMPT", "junk")
    assert elastic.elastic_attempt() == 0
    assert (elastic.ATTEMPT_ENV, elastic.ELASTIC_ENV) == \
        ("DPX_ELASTIC_ATTEMPT", "DPX_ELASTIC")


LM = ["--device", "cpu", "--dim", "16", "--n-layers", "1", "--n-heads", "2",
      "--seq-len", "16", "--batch-size", "2", "--data-size", "64",
      "--log-every", "1", "--optimizer", "adamw8bit", "--lr", "1e-2"]


def test_trainer_elastic_adamw8bit_commit_window_kill(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    log = tmp_path / "events.jsonl"
    ref = train_transformer_lm.main_worker(0, 0, LM + ["--steps", "9"],
                                           quiet=True)
    monkeypatch.setenv("DPX_METRICS_LOG", str(log))
    monkeypatch.setenv("DPX_TRACE", "1")
    # the saves at steps 0, 3 and 6 commit at the next save: the second
    # commit (step 3's, staged then committed while step 6 is saved)
    # dies between its renames
    monkeypatch.setenv("DPX_FAULT",
                       "kill@op=ckpt_commit_window,call=2,attempt=0")
    train_transformer_lm.main(LM + ["--steps", "9", "--save", ck,
                                    "--save-every", "3", "--elastic", "1",
                                    "--log", str(tmp_path / "m.jsonl")])
    events = _events(log)
    kinds = [e.get("event") for e in events]
    assert kinds.count("elastic_worker_exit") == 1
    assert kinds.count("elastic_recovered") == 1
    exit_ev = next(e for e in events if e.get("event") ==
                   "elastic_worker_exit")
    assert exit_ev["exitcode"] == faults.KILL_EXIT_CODE
    assert [(e["rank"], e["site"]) for e in events
            if e.get("event") == "fault_injected"] == \
        [(0, "op=ckpt_commit_window,call=2")]
    done = [e["metrics"] for e in events if e.get("event") ==
            "metrics_snapshot" and e.get("source") == "train_end"]
    assert len(done) == 1 and done[0]["train.end_step"] == 9
    start = int(done[0]["train.start_step"])
    assert start == 1          # step 0 was the last complete checkpoint
    steps = [json.loads(x) for x in
             open(tmp_path / "m.jsonl").read().splitlines()]
    resumed = {x["step"]: x["loss"] for x in steps[-(9 - start):]}
    assert sorted(resumed) == list(range(start, 9))
    assert [resumed[s] for s in range(start, 9)] == ref["losses"][start:]
