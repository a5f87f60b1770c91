"""Per-request SLO metrics: TTFT, TPOT and their aggregates.

The port's copy of ``distributed_pytorch_tpu/serve/metrics.py`` (trace
emission waits for the observability slice):

- **TTFT**: submit -> first emitted token, queue wait included.
- **TPOT**: mean inter-token gap after the first token,
  ``(last_token_t - first_token_t) / (n_tokens - 1)``; None for
  1-token outputs.

Disaggregated serving (``serve/disagg/``) splits TTFT along the handoff:
``queue_ms`` (submit -> prefill admission) + ``prefill_ms`` (admission
-> frame sent) + ``handoff_ms`` (sent -> taken off the transport by the
decode engine) + ``decode_ms`` (taken off -> first token sampled), with
the frame's ``handoff_bytes``. Every token, the first too, comes from
the decode engine, so TPOT is decode-engine time only. The spans are
absent for the monolithic engine.
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
    rec = {"request_id": req.request_id, "outcome": outcome,
           "prompt_len": int(len(req.prompt)), "n_tokens": n,
           "ttft_ms": ttft_ms, "tpot_ms": tpot_ms,
           "queue_ms": ((req.admit_t - req.submit_t) * 1e3
                        if req.admit_t is not None else None),
           "admit_iteration": req.admit_iteration,
           "retire_iteration": req.retire_iteration,
           # paged KV prefix sharing (0/0 when unpaged or cold)
           "prefix_hit_pages": req.prefix_hit_pages,
           "prefill_tokens_saved": req.prefill_tokens_saved,
           "tenant": req.tenant,
           # speculative decoding (0/0 when the request did not
           # speculate)
           "spec_proposed": req.spec_proposed,
           "spec_accepted": req.spec_accepted}
    if req.handoff_send_t is not None:
        # the disagg TTFT decomposition (None: the request failed
        # before reaching that stage)
        rec["prefill_ms"] = ((req.handoff_send_t - req.admit_t) * 1e3
                             if req.admit_t is not None else None)
        rec["handoff_ms"] = ((req.handoff_recv_t - req.handoff_send_t)
                             * 1e3 if req.handoff_recv_t is not None
                             else None)
        rec["decode_ms"] = ((req.first_token_t - req.handoff_recv_t)
                            * 1e3 if req.handoff_recv_t is not None
                            and req.first_token_t is not None else None)
        rec["handoff_bytes"] = req.handoff_bytes
    return rec


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
    saved = sum(r.get("prefill_tokens_saved") or 0 for r in ok)
    if saved:
        # prefix sharing (paged engines): prefill tokens skipped and
        # their share of all prompt tokens
        prompt_toks = sum(r["prompt_len"] for r in ok)
        out["prefill_tokens_saved"] = saved
        out["prefix_hit_rate"] = (round(saved / prompt_toks, 4)
                                  if prompt_toks else None)
        out["prefix_hit_pages"] = sum(r.get("prefix_hit_pages") or 0
                                      for r in ok)
    proposed = sum(r.get("spec_proposed") or 0 for r in ok)
    if proposed:
        # speculative decoding: accepted drafts over proposed drafts
        accepted = sum(r.get("spec_accepted") or 0 for r in ok)
        out["spec_proposed"] = proposed
        out["spec_accepted"] = accepted
        out["spec_acceptance_rate"] = round(accepted / proposed, 4)
    hand = [r["handoff_ms"] for r in ok
            if r.get("handoff_ms") is not None]
    if hand:
        # disaggregated serving: the handoff leg of TTFT and the frame
        # bytes moved prefill -> decode
        out["handoff_ms_p50"] = percentile(hand, 50)
        out["handoff_ms_p99"] = percentile(hand, 99)
        out["prefill_ms_p50"] = percentile(
            [r["prefill_ms"] for r in ok
             if r.get("prefill_ms") is not None], 50)
        out["handoff_bytes"] = sum(r.get("handoff_bytes") or 0
                                   for r in ok)
    if wall_s:
        out["wall_s"] = round(wall_s, 3)
        out["tokens_per_sec"] = round(toks / wall_s, 2)
    return out
