"""Straggler detection over merged per-rank spans.

Counterpart of ``distributed_pytorch_tpu/obs/detect.py``:

* per (op name, rank): the rank's duration median / IQR through
  ``perfbench/stats.summarize`` (no warmup discard: spans are not
  benchmark trials);
* per op name: each rank is fenced against the OTHER ranks' medians
  (leave-one-out): a rank whose median lies above
  ``median(peers) + k * IQR(peers)`` and above a 5 % relative floor is a
  straggler. Ops seen on fewer than 3 ranks are skipped: with one peer
  there is no spread to fence against, so two ranks never outvote each
  other.

Stdlib only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

__all__ = ["IQR_K", "REL_FLOOR", "op_durations", "summarize_ops",
           "stragglers"]

#: Default k of the k·IQR straggler gate (the classic robust outlier
#: fence; perfbench's spread gate is the same IQR vocabulary).
IQR_K = 3.0

#: Relative floor: a flagged rank must also exceed the across-rank
#: median by this fraction — absolute-µs jitter is not a straggler.
REL_FLOOR = 0.05


def _stats():
    # lazy: resolves under the dpxtrace CLI's fabricated parents too
    from ..perfbench import stats
    return stats


def op_durations(spans: Sequence[Dict[str, Any]]
                 ) -> Dict[str, Dict[Any, List[float]]]:
    """``{op name: {rank: [duration_ms, ...]}}`` over span records
    (rank falls back to pid for unattributed single-process spans)."""
    out: Dict[str, Dict[Any, List[float]]] = {}
    for s in spans:
        name = s.get("name")
        dur = s.get("dur_ns")
        if not name or not isinstance(dur, (int, float)) or dur <= 0:
            continue
        r = s.get("rank")
        if r is None:
            r = s.get("pid")
        out.setdefault(name, {}).setdefault(r, []).append(dur / 1e6)
    return out


def summarize_ops(spans: Sequence[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """Per-op per-rank summary table rows: count, median/IQR ms — the
    ``dpxtrace summarize`` payload."""
    st = _stats()
    rows: List[Dict[str, Any]] = []
    for name, by_rank in sorted(op_durations(spans).items()):
        for rank in sorted(by_rank, key=lambda r: (r is None, r)):
            durs = by_rank[rank]
            agg = st.summarize(durs, warmup=0, max_spread=float("inf"))
            rows.append({
                "op": name, "rank": rank, "count": len(durs),
                "median_ms": round(agg.median, 4),
                "iqr_ms": round(agg.iqr, 4),
                "total_ms": round(sum(durs), 3),
            })
    return rows


def stragglers(spans: Sequence[Dict[str, Any]], *,
               k: Optional[float] = None,
               min_ranks: int = 3) -> List[Dict[str, Any]]:
    """Flag (op, rank) pairs whose per-rank median duration lies outside
    the leave-one-out fence ``median(peers) + k·IQR(peers)`` (peers =
    the other ranks' medians for the same op), with the 5% relative
    floor.  Ops seen on fewer than ``min_ranks`` ranks are skipped;
    values below 3 are clamped to 3 — with fewer than two peers there
    is no spread to fence against (a single-peer "IQR" is 0 and would
    flag ANY gap), so two-rank worlds never produce a verdict."""
    st = _stats()
    k = IQR_K if k is None else float(k)
    findings: List[Dict[str, Any]] = []
    for name, by_rank in sorted(op_durations(spans).items()):
        if len(by_rank) < max(min_ranks, 3):
            continue
        medians = {
            r: st.summarize(d, warmup=0,
                            max_spread=float("inf")).median
            for r, d in by_rank.items()}
        for rank in sorted(medians, key=lambda r: (r is None, r)):
            m = medians[rank]
            peers = sorted(v for r2, v in medians.items() if r2 != rank)
            med = st._quantile(peers, 0.5)
            iqr = (st._quantile(peers, 0.75)
                   - st._quantile(peers, 0.25))
            if med <= 0:
                continue
            threshold = med + k * iqr
            if m > threshold and (m - med) / med > REL_FLOOR:
                findings.append({
                    "op": name, "rank": rank,
                    "median_ms": round(m, 4),
                    "world_median_ms": round(med, 4),
                    "iqr_ms": round(iqr, 4),
                    "threshold_ms": round(threshold, 4),
                    "excess_x": round(m / med, 2),
                    "n_ranks": len(by_rank),
                })
    findings.sort(key=lambda f: -f["excess_x"])
    return findings
