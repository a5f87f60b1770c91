"""Chaos campaigns of several faults, and the bounded retry of
transient faults that the campaigns prove.

Counterpart of ``distributed_pytorch_tpu/runtime/chaos.py``: the same
grammar, clause records, verdict and ``ValueError`` texts, so the
repo's ``tools/dpxchaos.py report`` reads a report this module's
:func:`clause_report` wrote. Stdlib only (imports :mod:`.env` and
:mod:`.faults`).

* :func:`call_with_retry` wraps the call sites where a retry is safe
  because nothing is in flight: the host group's rendezvous connect
  (``HostComm.__init__``) and the handoff transports' fault hooks
  (``serve/disagg/transport.py``). The budget is ``DPX_RETRY_MAX``
  retries, the k-th after ``DPX_RETRY_BACKOFF_MS * 2^(k-1)`` ms; every
  retry writes a ``comm_retry`` event; exhaustion raises the typed
  ``CommRetryExhausted`` with the attempt count. A collective that has
  moved data never retries: its recovery is an elastic restart.
* A campaign (``DPX_CHAOS``, a JSON file, or inline) is a sequence of
  clauses, each one ``DPX_FAULT`` spec with the leg it runs under and
  the outcome that makes it green; every spec is parsed at load, so a
  mistyped action or op is a ``ValueError`` naming it::

    DPX_CHAOS = json | path-to-json | compact
    compact   = clause [';' clause ...]
    clause    = [leg ':' expect ':'] fault-spec     # faults.py grammar

    json      = {"name": str, "clauses": [clause-obj ...]}
    clause-obj= {"fault": spec | "grid": {key: value-or-list, ...},
                 "leg": "train"|"train_shrink"|"serve"|"transport"|"fleet",
                 "expect": "typed_error"|"retry_recover"|"elastic_resume",
                 "id": str?, "env": {VAR: value}?, "note": str?}

  A ``grid`` clause expands to the cartesian product of its list-valued
  keys. :func:`clause_green` holds an observed row to its ``expect``;
  :func:`campaign_verdict` is green when every row is.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import env as _env
from . import faults as _faults

#: Env var holding the campaign spec (inline JSON, a JSON file path, or
#: the compact `;`-joined clause form).
CHAOS_ENV = "DPX_CHAOS"

#: Retry budget for transient faults: total attempts = 1 + DPX_RETRY_MAX.
RETRY_MAX_ENV = "DPX_RETRY_MAX"

#: Base backoff (ms) of the transient retry path; attempt k sleeps
#: base * 2^(k-1) ms before re-entering.
RETRY_BACKOFF_ENV = "DPX_RETRY_BACKOFF_MS"

LEGS = ("train", "train_shrink", "serve", "transport", "fleet")
EXPECTS = ("typed_error", "retry_recover", "elastic_resume")


# ---------------------------------------------------------------------------
# bounded retry for transient faults
# ---------------------------------------------------------------------------


def call_with_retry(fn: Callable[[], Any], *, op: str,
                    rank: Optional[int] = None,
                    transient: Optional[Tuple[type, ...]] = None,
                    max_retries: Optional[int] = None,
                    backoff_ms: Optional[float] = None,
                    sleep: Callable[[float], None] = time.sleep) -> Any:
    """Run ``fn()``; on a TRANSIENT failure, back off and re-enter, up
    to ``max_retries`` retries (``DPX_RETRY_MAX`` when None; total
    attempts = retries + 1) with exponential backoff from ``backoff_ms``
    (``DPX_RETRY_BACKOFF_MS``). Only exception types in ``transient``
    (default: :class:`.faults.FlakyFault`) are retried — anything else
    propagates untouched, first try.

    Every retry emits a ``comm_retry`` event (op/rank/attempt/backoff
    attributed) through ``utils.logging.append_event``, so a
    production log shows the flakiness even when the call ultimately
    succeeds. Exhaustion raises the typed
    :class:`..runtime.native.CommRetryExhausted` (a ``CommError``)
    carrying ``attempts`` and chaining the final transient error.

    ONLY wrap idempotent entry points: rendezvous connect (no link
    established yet) and the transport fault hooks (no bytes in flight).
    Never a collective that already moved data.
    """
    if max_retries is None:
        max_retries = _env.get(RETRY_MAX_ENV)
    if backoff_ms is None:
        backoff_ms = _env.get(RETRY_BACKOFF_ENV)
    if transient is None:
        transient = (_faults.FlakyFault,)
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except transient as e:
            if attempt > max_retries:
                from .native import CommRetryExhausted
                raise CommRetryExhausted(
                    f"{op}: transient fault persisted through {attempt} "
                    f"attempt(s) (retry budget {max_retries}): {e}",
                    op=op, rank=-1 if rank is None else rank,
                    attempts=attempt) from e
            delay_ms = float(backoff_ms) * (2 ** (attempt - 1))
            from ..utils.logging import append_event
            append_event("comm_retry", op=op,
                         rank=-1 if rank is None else rank,
                         attempt=attempt, backoff_ms=delay_ms,
                         error=type(e).__name__)
            sleep(delay_ms / 1000.0)


# ---------------------------------------------------------------------------
# campaign spec
# ---------------------------------------------------------------------------


@dataclass
class ChaosClause:
    """One armed fault of a campaign: the spec, where it runs, and what
    outcome makes it green."""

    fault: str                    # DPX_FAULT-grammar spec (validated)
    leg: str = "train"            # the harness it runs under (LEGS)
    expect: str = "typed_error"   # green condition (EXPECTS)
    id: str = ""                  # stable clause id (c00, c01, ...)
    env: Dict[str, str] = field(default_factory=dict)  # extra arming env
    note: str = ""
    specs: List[_faults.FaultSpec] = field(default_factory=list,
                                           compare=False)

    def arm_env(self) -> Dict[str, str]:
        """The environment that arms this clause in a leg process:
        the fault spec plus any per-clause overrides (e.g. a tightened
        ``DPX_RETRY_MAX`` for an exhaustion clause)."""
        out = {_faults.FAULT_ENV: self.fault}
        out.update({k: str(v) for k, v in self.env.items()})
        return out


@dataclass
class Campaign:
    name: str
    clauses: List[ChaosClause]


def _expand_grid(grid: Dict[str, Any]) -> List[str]:
    """Cartesian expansion of a grid clause into fault-spec strings.
    ``action`` is required; every other key is a spec key whose value
    may be a scalar or a list."""
    if "action" not in grid:
        raise ValueError(
            f"grid clause needs an 'action' key, got {sorted(grid)}")
    keys = [k for k in grid if k != "action"]
    actions = grid["action"]
    if not isinstance(actions, (list, tuple)):
        actions = [actions]
    axes = []
    for k in keys:
        v = grid[k]
        axes.append(v if isinstance(v, (list, tuple)) else [v])
    out = []
    for action in actions:
        for combo in itertools.product(*axes) if axes else [()]:
            kv = ",".join(f"{k}={v}" for k, v in zip(keys, combo))
            out.append(f"{action}@{kv}" if kv else str(action))
    return out


def _clause_from_obj(obj: Dict[str, Any], idx: int) -> List[ChaosClause]:
    if not isinstance(obj, dict):
        raise ValueError(f"clause #{idx} must be an object, got "
                         f"{type(obj).__name__}")
    unknown = set(obj) - {"fault", "grid", "leg", "expect", "id", "env",
                          "note"}
    if unknown:
        raise ValueError(
            f"clause #{idx}: unknown key(s) {sorted(unknown)} (expected "
            f"fault|grid, leg, expect, id, env, note)")
    if ("fault" in obj) == ("grid" in obj):
        raise ValueError(
            f"clause #{idx} needs exactly one of 'fault' or 'grid'")
    leg = obj.get("leg", "train")
    if leg not in LEGS:
        raise ValueError(
            f"clause #{idx}: unknown leg {leg!r} (expected one of {LEGS})")
    expect = obj.get("expect", "typed_error")
    if expect not in EXPECTS:
        raise ValueError(
            f"clause #{idx}: unknown expect {expect!r} (expected one of "
            f"{EXPECTS})")
    faults_strs = ([obj["fault"]] if "fault" in obj
                   else _expand_grid(obj["grid"]))
    out = []
    for j, f in enumerate(faults_strs):
        cid = obj.get("id", "")
        if cid and len(faults_strs) > 1:
            cid = f"{cid}.{j}"
        out.append(ChaosClause(
            fault=f, leg=leg, expect=expect, id=cid,
            env=dict(obj.get("env", {})), note=obj.get("note", ""),
            specs=_faults.parse_fault_spec(f)))
    return out


def _parse_compact_clause(text: str, idx: int) -> ChaosClause:
    """``[leg ':' expect ':'] fault-spec`` — the env-var-friendly form."""
    leg, expect, fault = "train", "typed_error", text
    parts = text.split(":")
    if len(parts) == 3:
        leg, expect, fault = (p.strip() for p in parts)
        if leg not in LEGS:
            raise ValueError(
                f"clause #{idx}: unknown leg {leg!r} (expected one of "
                f"{LEGS})")
        if expect not in EXPECTS:
            raise ValueError(
                f"clause #{idx}: unknown expect {expect!r} (expected one "
                f"of {EXPECTS})")
    elif len(parts) != 1:
        raise ValueError(
            f"clause #{idx}: compact clause is 'spec' or "
            f"'leg:expect:spec', got {text!r}")
    return ChaosClause(fault=fault, leg=leg, expect=expect,
                       specs=_faults.parse_fault_spec(fault))


def parse_campaign(src: Any, *, name: str = "campaign") -> Campaign:
    """Parse a campaign from a dict (the JSON shape), a list of clause
    objects, or a string — inline JSON (``{``/``[`` prefix), a path to
    a JSON file, or the compact ``;``-joined clause form. Every fault
    spec is validated through :func:`.faults.parse_fault_spec`, so a
    bad action/op/key is a ``ValueError`` at parse time."""
    if isinstance(src, str):
        text = src.strip()
        if not text:
            raise ValueError("empty campaign spec")
        if text[0] in "{[":
            try:
                src = json.loads(text)
            except json.JSONDecodeError as e:
                raise ValueError(f"campaign spec is not valid JSON: {e}")
        elif os.path.exists(text) or text.endswith(".json"):
            try:
                with open(text, "r", encoding="utf-8") as f:
                    src = json.load(f)
            except OSError as e:
                raise ValueError(f"cannot read campaign spec {text}: {e}")
            except json.JSONDecodeError as e:
                raise ValueError(f"campaign file {text} is not valid "
                                 f"JSON: {e}")
            name = os.path.splitext(os.path.basename(text))[0]
        else:
            clauses = [_parse_compact_clause(c.strip(), i)
                       for i, c in enumerate(text.split(";")) if c.strip()]
            return _finish(Campaign(name=name, clauses=clauses))
    if isinstance(src, list):
        src = {"name": name, "clauses": src}
    if not isinstance(src, dict):
        raise ValueError(
            f"campaign spec must be a dict/list/str, got "
            f"{type(src).__name__}")
    if "clauses" not in src or not isinstance(src["clauses"], list):
        raise ValueError("campaign spec needs a 'clauses' list")
    clauses: List[ChaosClause] = []
    for i, obj in enumerate(src["clauses"]):
        clauses.extend(_clause_from_obj(obj, i))
    return _finish(Campaign(name=str(src.get("name", name)),
                            clauses=clauses))


def _finish(campaign: Campaign) -> Campaign:
    if not campaign.clauses:
        raise ValueError("campaign has no clauses")
    for i, c in enumerate(campaign.clauses):
        if not c.id:
            c.id = f"c{i:02d}"
    return campaign


def load_campaign(default: Any = None) -> Optional[Campaign]:
    """The campaign armed via ``DPX_CHAOS`` (None when unset and no
    ``default`` spec is supplied)."""
    src = _env.raw(CHAOS_ENV)
    if src is None:
        src = default
    if src is None:
        return None
    return parse_campaign(src)


# ---------------------------------------------------------------------------
# per-clause report + verdict (shared with the dpxchaos CLI)
# ---------------------------------------------------------------------------


def clause_report(clause: ChaosClause, *, fired: bool,
                  typed_error: str = "", attributed: bool = False,
                  recovered: bool = False, retries: int = 0,
                  detail: str = "") -> Dict[str, Any]:
    """One observed report row for ``clause`` — the shape
    :func:`clause_green` and ``tools/dpxchaos.py report`` consume."""
    return {"id": clause.id, "fault": clause.fault, "leg": clause.leg,
            "expect": clause.expect, "fired": bool(fired),
            "typed_error": typed_error, "attributed": bool(attributed),
            "recovered": bool(recovered), "retries": int(retries),
            "detail": detail}


def clause_green(row: Dict[str, Any]) -> bool:
    """Did the clause do what the campaign declared? ``fired`` is table
    stakes (a clause that never injected proves nothing); the rest is
    per-``expect``: a typed, attributed error for ``typed_error``;
    retry-until-success with at least one ``comm_retry`` and NO terminal
    error for ``retry_recover``; a typed attributed failure AND a clean
    relaunch for ``elastic_resume``."""
    if not row.get("fired"):
        return False
    expect = row.get("expect")
    if expect == "typed_error":
        return bool(row.get("typed_error")) and bool(row.get("attributed"))
    if expect == "retry_recover":
        return (bool(row.get("recovered"))
                and int(row.get("retries", 0)) >= 1
                and not row.get("typed_error"))
    if expect == "elastic_resume":
        return (bool(row.get("typed_error"))
                and bool(row.get("attributed"))
                and bool(row.get("recovered")))
    return False


def campaign_verdict(rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Roll the per-clause rows into the campaign verdict dpxchaos
    gates on: ok iff every clause is green."""
    failing = [r.get("id", "?") for r in rows if not clause_green(r)]
    return {"clauses": len(rows), "green": len(rows) - len(failing),
            "failing": failing, "ok": not failing}
