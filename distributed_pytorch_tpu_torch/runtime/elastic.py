"""Elastic training: relaunch a crashed worker from its checkpoint.

Counterpart of ``distributed_pytorch_tpu/runtime/elastic.py``. The
reference's failure story ends at detection (its ``join=True`` spawn
surfaces child errors; recovery is the user running the command again,
reference ``README.md:121-125``). :func:`elastic_run` runs the training
entry point in a supervised child process and, when it dies (a crash,
an injected ``kill``, an OOM kill, a watchdog abort), relaunches it up
to ``max_restarts`` times with a doubling backoff. Workers make this
exact by resuming from their latest checkpoint (``--save DIR`` with
``--resume``, which the trainer's ``--elastic`` appends once the
directory holds one), so a relaunch repeats no optimizer step.

The child is a fresh process made by ``spawn`` only: a ``fork`` after
CUDA is initialised in the supervisor is invalid, and a fresh process
initialises the card anew. The attempt number is exported to the child
as ``DPX_ELASTIC_ATTEMPT`` (0 first) and ``DPX_ELASTIC=1`` marks it as
supervised; both, and the caller's ``env``, are set in the child only.
``DPX_PLATFORM=cpu`` hides the cards from the child. A child that fails
is reported by its exit code (an ``elastic_worker_exit`` event per
failure, the ``elastic.attempts`` / ``elastic.last_exit_code`` gauges),
and a give-up raises :class:`~.watchdog.WorkerFailure`.

``reconfigure(attempt, exitcode, args)`` may rewrite the arguments
between attempts (a smaller world after a host loss); the sharded
checkpoint (``ckpt/``) reshards the restore onto whatever the relaunch
builds.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from typing import Callable, NamedTuple, Optional, Sequence

from . import env as _env
from .watchdog import WorkerFailure

ATTEMPT_ENV = "DPX_ELASTIC_ATTEMPT"
ELASTIC_ENV = "DPX_ELASTIC"


class ElasticResult(NamedTuple):
    restarts: int          # how many times the worker was relaunched
    exitcodes: tuple       # exit code of every attempt (last one is 0)


def _child_bootstrap(target, args, child_env):
    """The spawned child's entry (module level, so spawn can pickle it).
    Exports the elastic bookkeeping and the caller's env in the child
    (a leaked ``DPX_ELASTIC`` would make the supervisor claim to be
    supervised), then applies ``DPX_PLATFORM``: ``cpu`` hides the cards
    (``CUDA_VISIBLE_DEVICES`` empty, before anything initialises CUDA)
    and makes the CPU the default device."""
    _env.apply_overrides(child_env)
    if _env.get("DPX_PLATFORM") == "cpu":
        _env.apply_overrides({"CUDA_VISIBLE_DEVICES": ""})
        import torch
        torch.set_default_device("cpu")
    target(*args)


def elastic_run(target: Callable, args: Sequence = (), *,
                max_restarts: int = 3, backoff_s: float = 1.0,
                env: Optional[dict] = None,
                reconfigure: Optional[Callable] = None) -> ElasticResult:
    """Run ``target(*args)`` in a spawned process; relaunch on failure.

    ``target`` must be picklable (module-level) and resume-idempotent:
    on restart it is called with the SAME arguments and is expected to
    pick up from its latest checkpoint. Returns once an attempt exits 0;
    raises :class:`watchdog.WorkerFailure` when ``max_restarts``
    relaunches are exhausted. ``backoff_s`` doubles per restart (a
    crashing-on-start worker must not busy-loop the host). ``env``
    entries are exported to the child (on top of the parent's
    environment).

    ``reconfigure(attempt, exitcode, args) -> args | None`` runs before
    each relaunch (``attempt`` = the upcoming attempt number, ``exitcode``
    = the failed attempt's exit code) and may return NEW arguments for the
    next attempt — the topology-shrink hook: after a host dies, relaunch
    the worker on a smaller world and let the sharded checkpoint
    subsystem (``ckpt/``) reshard the restore onto it, instead of
    demanding the original world size back. Returning None keeps the
    previous arguments. The child is always spawned: a fork after CUDA
    is initialised is invalid.
    """
    from ..obs import metrics as _dpxmon
    from ..utils.logging import append_event

    ctx = mp.get_context("spawn")
    codes = []
    args = tuple(args)
    for attempt in range(max_restarts + 1):
        if attempt > 0 and reconfigure is not None:
            new_args = reconfigure(attempt, codes[-1], args)
            if new_args is not None and tuple(new_args) != args:
                args = tuple(new_args)
                append_event("elastic_reconfigured", attempt=attempt,
                             args=[str(a) for a in args])
        child_env = {ATTEMPT_ENV: str(attempt), ELASTIC_ENV: "1"}
        if env:
            child_env.update({k: str(v) for k, v in env.items()})
        p = ctx.Process(target=_child_bootstrap,
                        args=(target, tuple(args), child_env))
        p.start()
        try:
            # the supervisor waits the worker out: its deadlines live
            # inside it
            p.join()
        except BaseException:
            # supervisor interrupted (KeyboardInterrupt, an exception in
            # our own machinery): the child must not outlive us as an
            # orphan still holding ports/checkpoint locks
            if p.is_alive():
                p.terminate()
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()  # the reap after SIGKILL returns at once
            raise
        codes.append(p.exitcode)
        # dpxmon gauges (obs/metrics.py): relaunch churn is alertable
        # BEFORE giveup — a monitor rule on elastic.attempts catches a
        # crash-looping worker while restarts are still being burned
        _dpxmon.set_gauge("elastic.attempts", attempt + 1)
        _dpxmon.set_gauge("elastic.last_exit_code", p.exitcode)
        if p.exitcode == 0:
            if attempt > 0:
                append_event("elastic_recovered", restarts=attempt,
                             exitcodes=codes)
            return ElasticResult(restarts=attempt, exitcodes=tuple(codes))
        append_event("elastic_worker_exit", attempt=attempt,
                     exitcode=p.exitcode,
                     restarts_left=max_restarts - attempt)
        if attempt < max_restarts:
            sleep = backoff_s * (2 ** attempt)
            print(f"# elastic: attempt {attempt} exited "
                  f"{p.exitcode}; relaunching in {sleep:.1f}s "
                  f"({max_restarts - attempt} restart(s) left)", flush=True)
            time.sleep(sleep)
    append_event("elastic_giveup", attempts=max_restarts + 1,
                 exitcodes=codes)
    raise WorkerFailure(
        f"worker failed {max_restarts + 1} times "
        f"(exit codes {codes}); giving up", exitcode=codes[-1])


def elastic_attempt() -> int:
    """The current process's restart attempt number (0 = first launch,
    also when not running under :func:`elastic_run`)."""
    return _env.get(ATTEMPT_ENV)


def is_elastic() -> bool:
    """Whether this process is supervised by :func:`elastic_run`."""
    return _env.get(ELASTIC_ENV)
