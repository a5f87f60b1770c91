"""Deterministic fault injection: a rank that dies mid-collective, a
stalled rank, a dropped link, a divergent collective, a transient
refusal, each at a test-addressable point.

Counterpart of ``distributed_pytorch_tpu/runtime/faults.py``, with the
same grammar, op vocabulary, matching rules and error texts; stdlib
only, as there. Faults come from ``DPX_FAULT`` (a spawned rank picks its
fault up with no plumbing) or :func:`install`::

    DPX_FAULT = spec [';' spec ...]
    spec      = action '@' key '=' value [',' key '=' value ...]
    action    = 'kill' | 'delay' | 'drop_conn' | 'diverge' | 'flaky'
    key       = 'step' | 'rank' | 'op' | 'call' | 'ms' | 'attempt'
              | 'count'

    kill@step=3,rank=1            # rank 1 hard-exits at train step 3
    delay@op=allreduce,ms=500     # stall every allreduce 500 ms
    kill@op=ckpt_commit_window,call=2,attempt=0
        # die inside the second commit's rename window, on the first
        # elastic attempt only (the relaunch runs clean)

Every present key must match; an absent key matches everything.
``rank`` is the calling rank (a rank-scoped spec never fires from a
hook that cannot name its rank); ``op`` one of :data:`COMM_OPS` (or a
:func:`register_op` extension), fired from :func:`on_comm_op`; ``call``
the Nth (1-based) call of that op in this process; ``step`` the train
step of :func:`on_step` (specs without ``op`` fire there; with ``op`` it
filters on the latest step seen); ``attempt`` the elastic attempt
(``DPX_ELASTIC_ATTEMPT``); ``ms`` the stall of ``delay``; ``count`` the
transient failures of ``flaky``.

Where the port fires each op: ``runtime/native.py``'s ``HostComm``
before every native collective (``init`` before each rendezvous
attempt, retried by ``chaos.call_with_retry``; the sharded update's legs
as ``reduce_scatter`` / ``allgather``), ``comm/hier.py`` for the two
phases of the hierarchical ring, the checkpoint save path (``ckpt`` at
each write, ``ckpt_commit`` at commit entry, ``ckpt_commit_window``
between the two renames), the serving engine (``serve_step`` once per
iteration, ``draft_propose`` / ``spec_verify`` in speculation), the
paged pool (``page_admit`` per allocation attempt, ``page_evict`` per
LRU eviction), the disaggregated transports (``handoff_send`` /
``handoff_recv``) and the fleet router (``fleet_submit``).

Actions: ``kill`` is ``os._exit(43)`` after a ``fault_injected`` event
(a trace event, and a line of ``DPX_METRICS_LOG``) and a flight-recorder
dump (no cleanup, as a SIGKILL); ``delay`` sleeps;
``drop_conn`` aborts the target's links (the hook's comm, else every
registered comm); ``diverge`` calls one extra ``barrier()`` that the
peers do not; ``flaky`` raises :class:`FlakyFault` ``count`` times
(default 1), then lets the op through. Nothing is random: counters move
only at hook sites, so a spec and a call history always inject at the
same point. With nothing armed a hook costs one environment read and
one ``if``.
"""

from __future__ import annotations

import os
import sys
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import env as _env

#: Env var holding the fault spec(s).
FAULT_ENV = "DPX_FAULT"

#: Exit code of an injected ``kill`` — distinct from real crashes so a
#: supervisor/test can tell an injected death from an organic one.
KILL_EXIT_CODE = 43

_ACTIONS = ("kill", "delay", "drop_conn", "diverge", "flaky")
_INT_KEYS = ("step", "rank", "call", "ms", "attempt", "count")


class FlakyFault(RuntimeError):
    """The injected TRANSIENT failure of the ``flaky`` action: raised at
    the hook site for the spec's first ``count`` matches, after which the
    op goes through clean. The retry wrappers in ``runtime/chaos.py``
    recognize it as retryable; everything else treats it as the terminal
    error it would be in production."""


#: Comm-layer op names that fire op-scoped specs from :func:`on_comm_op`
#: (the HostComm hook sites). ``parse_fault_spec`` VALIDATES ``op=``
#: values against this vocabulary (plus :func:`register_op` extensions) —
#: a typo'd op name must fail at parse time, not silently never fire.
#: ``allreduce_q4`` is the 4-bit adaptive-wire ring (the width is part
#: of the op name, so a width-scoped fault targets exactly the q4
#: steps); ``reduce_scatter``/``allgather`` are the sharded-weight-
#: update legs (optim/sharded/); ``hier_reduce``/``hier_gather`` are
#: the two phases of the hierarchical two-level ring (comm/hier.py —
#: ``kill@op=hier_reduce`` dies entering the intra-host reduce +
#: leader-ring scatter phase); ``ckpt*`` ops fire from the checkpoint
#: save path and ``serve_step`` from the serving engine's iteration
#: hook.
#: ``init`` is the rendezvous-connect hook (``HostComm.__init__`` fires
#: it before each native ``dpx_comm_init`` attempt — the retry-wrapped
#: site, so ``flaky@op=init,rank=1,count=2`` makes rank 1's rendezvous
#: refuse twice and then connect).
COMM_OPS = ("init",
            "allreduce", "allreduce_q8", "allreduce_q4",
            "reduce_scatter", "allgather", "hier_reduce", "hier_gather",
            "reduce", "gather", "broadcast", "barrier",
            "ckpt", "ckpt_commit", "ckpt_commit_window", "serve_step",
            "page_admit", "page_evict", "handoff_send", "handoff_recv",
            "fleet_submit", "draft_propose", "spec_verify")

_extra_ops: set = set()


def register_op(op: str) -> None:
    """Extend the op vocabulary :func:`parse_fault_spec` accepts — the
    escape hatch for out-of-tree hook sites that call :func:`on_comm_op`
    with their own op names. Idempotent; process-local."""
    _extra_ops.add(op)


def registered_ops() -> tuple:
    """The full op vocabulary (built-in + registered extensions)."""
    return COMM_OPS + tuple(sorted(_extra_ops))


@dataclass
class FaultSpec:
    action: str
    step: Optional[int] = None
    rank: Optional[int] = None
    op: Optional[str] = None
    call: Optional[int] = None
    ms: Optional[int] = None
    attempt: Optional[int] = None
    count: Optional[int] = None       # flaky: matches that raise (def. 1)
    fired: bool = field(default=False, compare=False)
    left: Optional[int] = field(default=None, compare=False)  # flaky budget

    def matches_rank_attempt(self, rank: Optional[int]) -> bool:
        # a rank-scoped spec never fires from a hook that cannot say
        # which rank it is — firing "just in case" would turn a
        # one-rank kill into a whole-world kill
        if self.rank is not None and (rank is None or rank != self.rank):
            return False
        if self.attempt is not None:
            cur = _env.get("DPX_ELASTIC_ATTEMPT")
            if cur != self.attempt:
                return False
        return True


def parse_fault_spec(spec: str) -> List[FaultSpec]:
    """Parse a ``DPX_FAULT`` string into :class:`FaultSpec` objects.

    Raises ``ValueError`` on malformed input — a typo'd fault spec that
    silently injects nothing would make a chaos test vacuously green.
    """
    out = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        action, _, args = part.partition("@")
        action = action.strip()
        if action not in _ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} (expected one of "
                f"{_ACTIONS}) in {part!r}")
        kw: Dict[str, object] = {}
        for tok in filter(None, (t.strip() for t in args.split(","))):
            key, eq, val = tok.partition("=")
            if not eq or key not in _INT_KEYS + ("op",):
                raise ValueError(f"bad fault key {tok!r} in {part!r}")
            if key == "op" and val not in COMM_OPS \
                    and val not in _extra_ops:
                # a misspelled op would otherwise arm a spec that can
                # never fire — the chaos test goes vacuously green
                raise ValueError(
                    f"unregistered fault op {val!r} in {part!r} — "
                    f"registered ops: {', '.join(registered_ops())} "
                    f"(extend via faults.register_op)")
            kw[key] = val if key == "op" else int(val)
        if action == "delay" and "ms" not in kw:
            raise ValueError(f"delay fault needs ms= in {part!r}")
        if action != "flaky" and "count" in kw:
            raise ValueError(
                f"count= is only meaningful for flaky faults in {part!r}")
        out.append(FaultSpec(action=action, **kw))
    return out


# ---------------------------------------------------------------------------
# process-local injection state
# ---------------------------------------------------------------------------

_specs: Optional[List[FaultSpec]] = None
_specs_src: Optional[str] = None     # the env/install string _specs parsed
_op_calls: Dict[str, int] = {}       # op name -> calls seen so far
_cur_step: Optional[int] = None      # latest step reported via on_step
_comms: List = []                    # weakrefs to live HostComms
_log: List[str] = []                 # injection sites that fired (tests)


def install(spec: Optional[str]) -> List[FaultSpec]:
    """Programmatically (re)install fault specs (None/"" clears them).
    Also exports ``DPX_FAULT`` so spawned children inherit the faults."""
    global _specs, _specs_src
    if spec:
        _env.set(FAULT_ENV, spec)
    else:
        _env.unset(FAULT_ENV)
    _specs = parse_fault_spec(spec) if spec else []
    _specs_src = spec or ""
    return _specs


def reset() -> None:
    """Clear all injection state AND counters (test isolation). Also
    drops ``DPX_FAULT`` from the environment — otherwise the next hook
    call would re-parse it and resurrect the specs with fresh (unfired)
    state."""
    global _specs, _specs_src, _cur_step
    _env.unset(FAULT_ENV)
    _specs = None
    _specs_src = None
    _cur_step = None
    _op_calls.clear()
    _comms.clear()
    _log.clear()


def fired() -> List[str]:
    """Injection sites that fired in this process (newest last)."""
    return list(_log)


def armed() -> bool:
    """Whether any fault spec is live in this process. Hot paths that
    would otherwise pay a retry-wrapper closure per call (the
    transport's recv(0) busy-poll) gate on this — with nothing armed
    the hook is a no-op, so skipping it entirely is equivalent."""
    return bool(_active())


def _active() -> List[FaultSpec]:
    """The live spec list, re-parsed whenever ``DPX_FAULT`` changes."""
    global _specs, _specs_src
    env = _env.raw(FAULT_ENV) or ""
    if _specs is None or env != _specs_src:
        _specs = parse_fault_spec(env) if env else []
        _specs_src = env
    return _specs


def register_comm(comm) -> None:
    """Track a live HostComm so step-scoped ``drop_conn`` can reach it."""
    _comms.append(weakref.ref(comm))


def _live_comms():
    out = []
    for ref in list(_comms):
        c = ref()
        if c is None:
            _comms.remove(ref)
        else:
            out.append(c)
    return out


def _fire(spec: FaultSpec, site: str, rank: Optional[int], comm) -> None:
    if spec.action == "flaky":
        # a bounded budget of transient failures, then the op succeeds:
        # fired flips once the budget is spent so later matches pass
        if spec.left is None:
            spec.left = spec.count if spec.count is not None else 1
        spec.left -= 1
        if spec.left <= 0:
            spec.fired = True
    elif spec.action != "delay":
        spec.fired = True  # kill/drop_conn are one-shot; delay repeats
    _log.append(f"{spec.action}@{site}")
    print(f"# fault-injection: {spec.action} firing at {site} "
          f"(rank {rank})", file=sys.stderr, flush=True)
    # the injection lands on the trace timeline next to the spans it
    # perturbs (obs/trace.py), and as an event of its own in the metrics
    # log: a kill inside a span never closes that span, so only the
    # event outlives the process
    from ..obs import trace as _dpxtrace
    from ..utils.logging import append_event
    _dpxtrace.event("fault_injected", action=spec.action, site=site,
                    rank=rank)
    append_event("fault_injected", action=spec.action, site=site,
                 rank=-1 if rank is None else rank)
    if spec.action == "kill":
        # the dying rank ships its own timeline before the hard exit
        _dpxtrace.flight_dump("fault_kill", rank=rank, site=site)
        os._exit(KILL_EXIT_CODE)  # hard death: no cleanup, like SIGKILL
    elif spec.action == "delay":
        time.sleep((spec.ms or 0) / 1000.0)
    elif spec.action == "drop_conn":
        targets = [comm] if comm is not None else _live_comms()
        for c in targets:
            c.abort()
    elif spec.action == "diverge":
        # a collective the peers do not call (an extra
        # barrier): the mismatched-schedule bug class. fired=True was
        # already set above, so the nested hook call cannot re-fire.
        targets = [comm] if comm is not None else _live_comms()
        for c in targets:
            c.barrier()
    elif spec.action == "flaky":
        raise FlakyFault(
            f"injected transient fault at {site} (rank {rank})")


def on_comm_op(op: str, rank: Optional[int] = None, comm=None) -> None:
    """Hook: called by the comm layer before every native collective."""
    specs = _active()
    if not specs:
        return
    n = _op_calls[op] = _op_calls.get(op, 0) + 1
    for spec in specs:
        if spec.op is None or spec.fired:
            continue
        if spec.op != op:
            continue
        if spec.call is not None and spec.call != n:
            continue
        if spec.step is not None and spec.step != _cur_step:
            continue
        if not spec.matches_rank_attempt(rank):
            continue
        _fire(spec, f"op={op},call={n}", rank, comm)


#: The op name under which the serving engine's iteration hook fires
#: op-scoped specs (``serve/engine.py`` calls once per engine iteration).
SERVE_OP = "serve_step"


def on_serve_iteration(iteration: int, rank: Optional[int] = None) -> None:
    """Hook: the serving engine calls this once per engine iteration.

    Fires both vocabularies: step-scoped specs with the iteration as
    the step (``kill@step=7`` hard-kills the serving process at
    iteration 7 — subprocess chaos tests only), and op-scoped specs
    under ``op=serve_step`` with per-process call counting
    (``delay@op=serve_step,call=5,ms=400`` stalls iteration 5)."""
    on_step(iteration, rank=rank)
    on_comm_op(SERVE_OP, rank=rank)


def on_step(step: int, rank: Optional[int] = None) -> None:
    """Hook: called by training loops once per step (before the step's
    compute). Fires step-scoped specs and records the step so op-scoped
    specs can filter on it."""
    global _cur_step
    _cur_step = step
    specs = _active()
    if not specs:
        return
    for spec in specs:
        if spec.op is not None or spec.fired:
            continue  # op-scoped specs fire from on_comm_op
        if spec.step is not None and spec.step != step:
            continue
        if not spec.matches_rank_attempt(rank):
            continue
        _fire(spec, f"step={step}", rank, None)
