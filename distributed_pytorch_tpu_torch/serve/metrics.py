"""Per-request SLO metrics: TTFT, TPOT and their aggregates.

The port's copy of ``distributed_pytorch_tpu/serve/metrics.py`` (trace
emission waits for the observability slice):

- **TTFT**: submit -> first emitted token, queue wait included.
- **TPOT**: mean inter-token gap after the first token,
  ``(last_token_t - first_token_t) / (n_tokens - 1)``; None for
  1-token outputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .types import Request


def request_record(req: Request, outcome: str) -> Dict:
    """The per-request SLO record (metrics log and ``handle.metrics``)."""
    n = len(req.out_tokens)
    ttft_ms = tpot_ms = None
    if req.first_token_t is not None:
        ttft_ms = (req.first_token_t - req.submit_t) * 1e3
        if n > 1 and req.last_token_t is not None:
            tpot_ms = (req.last_token_t - req.first_token_t) * 1e3 / (n - 1)
    return {"request_id": req.request_id, "outcome": outcome,
            "prompt_len": int(len(req.prompt)), "n_tokens": n,
            "ttft_ms": ttft_ms, "tpot_ms": tpot_ms,
            "queue_ms": ((req.admit_t - req.submit_t) * 1e3
                         if req.admit_t is not None else None),
            "admit_iteration": req.admit_iteration,
            "retire_iteration": req.retire_iteration}


def percentile(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile without numpy."""
    xs = sorted(x for x in xs if x is not None)
    if not xs:
        return None
    i = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[i]


def aggregate(records: List[Dict], wall_s: Optional[float] = None) -> Dict:
    """Summary over per-request records: p50/p99 TTFT and TPOT, tokens/s,
    outcome counts."""
    ok = [r for r in records if r["outcome"] == "ok"]
    ttft = [r["ttft_ms"] for r in ok if r["ttft_ms"] is not None]
    tpot = [r["tpot_ms"] for r in ok if r["tpot_ms"] is not None]
    toks = sum(r["n_tokens"] for r in ok)
    out = {
        "n_requests": len(records),
        "n_ok": len(ok),
        "outcomes": {o: sum(1 for r in records if r["outcome"] == o)
                     for o in sorted({r["outcome"] for r in records})},
        "total_tokens": toks,
        "ttft_ms_p50": percentile(ttft, 50),
        "ttft_ms_p99": percentile(ttft, 99),
        "tpot_ms_p50": percentile(tpot, 50),
        "tpot_ms_p99": percentile(tpot, 99),
    }
    if wall_s:
        out["wall_s"] = round(wall_s, 3)
        out["tokens_per_sec"] = round(toks / wall_s, 2)
    return out
