"""Trial statistics: the one statistical policy behind every repeated
measurement of the port.

Counterpart of ``distributed_pytorch_tpu/perfbench/stats.py``:

* **warmup discard**: the first ``DPX_BENCH_WARMUP`` trials are recorded
  but left out of the aggregate;
* **median + IQR**: the aggregate is the median of the kept trials,
  ``spread_frac`` = IQR / median, and the full range is reported beside
  it as ``range_frac``;
* **a hard spread gate**: ``spread_frac > DPX_BENCH_MAX_SPREAD`` (or
  fewer than ``MIN_TRUSTED_TRIALS`` kept trials) marks the stats
  untrusted with a reason, and :func:`gated_ratio` withholds a ratio
  built on an untrusted side.

:func:`pin_process` and :func:`pin_torch_threads` fix the CPU set and
torch's thread count when a caller asks; nothing is pinned at import.
Stdlib only at module level; the env registry is imported lazily.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional, Sequence, Tuple

__all__ = ["TrialStats", "summarize", "measure", "measure_until",
           "gated_ratio", "pin_process", "pin_torch_threads",
           "MIN_TRUSTED_TRIALS"]

#: Below this many KEPT (post-warmup) trials no spread estimate is
#: meaningful, so the stats are untrusted regardless of the gate.
MIN_TRUSTED_TRIALS = 3


def _env():
    from ..runtime import env
    return env


def _default(name: str, override):
    return _env().get(name) if override is None else override


@dataclasses.dataclass(frozen=True)
class TrialStats:
    """Aggregate of repeated trials of one scalar measurement."""

    median: float
    q25: float
    q75: float
    iqr: float
    spread_frac: float        # IQR / median — the gated dispersion
    range_frac: float         # (max - min) / median — reported, not gated
    runs: Tuple[float, ...]   # kept trials, chronological
    warmup_discarded: Tuple[float, ...]
    trusted: bool
    untrusted_reason: Optional[str] = None

    @property
    def n(self) -> int:
        return len(self.runs)

    def to_dict(self, nd: int = 4) -> dict:
        d = {
            "median": round(self.median, nd),
            "q25": round(self.q25, nd),
            "q75": round(self.q75, nd),
            "iqr": round(self.iqr, nd),
            "spread_frac": round(self.spread_frac, 4),
            "range_frac": round(self.range_frac, 4),
            "n_trials": self.n,
            "runs": [round(r, nd) for r in self.runs],
            "warmup_discarded": [round(r, nd)
                                 for r in self.warmup_discarded],
            "trusted": self.trusted,
        }
        if self.untrusted_reason:
            d["untrusted_reason"] = self.untrusted_reason
        return d


def _quantile(sorted_xs: Sequence[float], q: float) -> float:
    """Linear-interpolated quantile of an already-sorted sample."""
    if not sorted_xs:
        raise ValueError("quantile of empty sample")
    if len(sorted_xs) == 1:
        return float(sorted_xs[0])
    pos = q * (len(sorted_xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_xs) - 1)
    frac = pos - lo
    return float(sorted_xs[lo] * (1.0 - frac) + sorted_xs[hi] * frac)


def summarize(runs: Sequence[float], *, warmup: Optional[int] = None,
              max_spread: Optional[float] = None) -> TrialStats:
    """Aggregate chronological ``runs`` under the repo statistical policy.

    The first ``warmup`` trials (default ``DPX_BENCH_WARMUP``) are
    discarded — but never so many that nothing is left.  The gate
    (default ``DPX_BENCH_MAX_SPREAD``) and the minimum-trials rule
    decide ``trusted``.
    """
    runs = [float(r) for r in runs]
    if not runs:
        raise ValueError("summarize() needs at least one trial")
    warmup = int(_default("DPX_BENCH_WARMUP", warmup))
    max_spread = float(_default("DPX_BENCH_MAX_SPREAD", max_spread))
    n_discard = max(0, min(warmup, len(runs) - 1))
    discarded, kept = tuple(runs[:n_discard]), tuple(runs[n_discard:])

    s = sorted(kept)
    med = _quantile(s, 0.5)
    q25, q75 = _quantile(s, 0.25), _quantile(s, 0.75)
    iqr = q75 - q25
    spread = iqr / med if med else 0.0
    rng = (s[-1] - s[0]) / med if med else 0.0

    reason = None
    if len(kept) < MIN_TRUSTED_TRIALS:
        reason = (f"too few trials ({len(kept)} < {MIN_TRUSTED_TRIALS} "
                  f"after warmup discard)")
    elif spread > max_spread:
        reason = (f"spread {spread:.0%} (IQR/median) exceeds gate "
                  f"{max_spread:.0%}")
    return TrialStats(median=med, q25=q25, q75=q75, iqr=iqr,
                      spread_frac=spread, range_frac=rng, runs=kept,
                      warmup_discarded=discarded, trusted=reason is None,
                      untrusted_reason=reason)


def measure(thunk: Callable[[], float], *, trials: Optional[int] = None,
            warmup: Optional[int] = None,
            max_spread: Optional[float] = None) -> TrialStats:
    """Run ``thunk`` (returning one scalar sample per call) ``warmup +
    trials`` times and :func:`summarize` the samples.  The warmup runs
    execute for real — their purpose is to absorb the cold-start
    artifact — and stay visible in ``warmup_discarded``."""
    trials = int(_default("DPX_BENCH_TRIALS", trials))
    warmup = int(_default("DPX_BENCH_WARMUP", warmup))
    if trials < 1:
        raise ValueError(f"trials must be >= 1, got {trials}")
    samples = [float(thunk()) for _ in range(warmup + trials)]
    return summarize(samples, warmup=warmup, max_spread=max_spread)


def measure_until(thunk: Callable[[], float], *,
                  trials: Optional[int] = None,
                  warmup: Optional[int] = None,
                  max_spread: Optional[float] = None,
                  budget_s: Optional[float] = None) -> TrialStats:
    """Sample ``thunk`` until the LAST ``trials`` samples pass the
    spread gate, or ``budget_s`` of wall clock is spent.

    :func:`measure`'s fixed-count policy assumes the host's available
    CPU is stationary across the trial set.  A heavily shared host
    breaks that: steal time is invisible, and measured throughput
    swings 2x over tens of seconds as neighbors come and go.  The honest fixed-count result is then
    "untrusted" forever: correct, but useless as a gate.  This
    variant instead hunts for a *stationary window*: after each new
    sample it re-aggregates the newest ``trials`` samples (a sliding
    window, warmup already spent), and returns the first window that
    passes the gate.  A contention mode switch mid-run ages out of the
    window instead of poisoning the whole estimate.  If no window
    converges within the budget the LAST window is returned untrusted,
    with the gate's reason — the budget bounds wall clock, never
    launders a noisy result into a trusted one.

    All pre-window samples (initial warmup plus everything that aged
    out) are visible in ``warmup_discarded``, chronological.
    """
    trials = int(_default("DPX_BENCH_TRIALS", trials))
    warmup = int(_default("DPX_BENCH_WARMUP", warmup))
    max_spread = float(_default("DPX_BENCH_MAX_SPREAD", max_spread))
    if budget_s is None:
        budget_s = float(_env().get("DPX_BENCH_BUDGET_S"))
    if trials < 1:
        raise ValueError(f"trials must be >= 1, got {trials}")
    samples: list = []
    t0 = time.monotonic()
    st: Optional[TrialStats] = None
    while True:
        samples.append(float(thunk()))
        if len(samples) >= warmup + trials:
            st = summarize(samples[-trials:], warmup=0,
                           max_spread=max_spread)
            st = dataclasses.replace(
                st, warmup_discarded=tuple(samples[:-trials]))
            if st.trusted:
                return st
        if time.monotonic() - t0 >= budget_s:
            if st is None:   # budget gone before one full window existed
                st = summarize(samples, warmup=warmup,
                               max_spread=max_spread)
            if st.trusted:
                return st
            return dataclasses.replace(
                st, untrusted_reason=(
                    f"no stationary window within {budget_s:.0f}s budget"
                    f" ({len(samples)} samples): {st.untrusted_reason}"))


def gated_ratio(numerator, denominator: TrialStats
                ) -> Tuple[Optional[float], Optional[str]]:
    """``numerator / denominator.median`` — or ``(None, reason)``.

    A ratio whose either side
    failed the spread gate is noise presented as signal, so the ratio is
    *withheld with a reason* rather than printed.  ``numerator`` may be
    a :class:`TrialStats` (both sides gated) or a plain float (a single
    measured value whose own dispersion is unknown but which is not a
    repeated-trials estimate — e.g. a tokens/s figure from an on-chip
    stage; only the denominator is gated then).
    """
    if isinstance(numerator, TrialStats):
        if not numerator.trusted:
            return None, f"numerator untrusted: {numerator.untrusted_reason}"
        num = numerator.median
    else:
        if numerator is None:
            return None, "numerator missing"
        num = float(numerator)
    if not denominator.trusted:
        return None, f"denominator untrusted: {denominator.untrusted_reason}"
    if not denominator.median:
        return None, "denominator median is zero"
    return num / denominator.median, None


# ---------------------------------------------------------------------------
# noise-source pinning
# ---------------------------------------------------------------------------

def pin_process(n_cpus: Optional[int] = None) -> Optional[int]:
    """Pin this process (and its future children) to a deterministic CPU
    subset: the first ``n_cpus`` of the currently-allowed set.  Returns
    the resulting set size, or None when pinning is disabled/unsupported.

    Default ``n_cpus`` comes from ``DPX_BENCH_AFFINITY`` (0 = leave
    affinity alone).  Scheduler migration across a large contended host
    is a variance source on a contended host; a fixed subset
    keeps run-to-run placement comparable.
    """
    if n_cpus is None:
        n_cpus = int(_env().get("DPX_BENCH_AFFINITY"))
    if n_cpus <= 0 or not hasattr(os, "sched_setaffinity"):
        return None
    try:
        allowed = sorted(os.sched_getaffinity(0))
        subset = set(allowed[:n_cpus])
        os.sched_setaffinity(0, subset)
        return len(subset)
    except OSError:
        return None


def pin_torch_threads(torch, n: Optional[int] = None) -> None:
    """Pin torch to a fixed intra-op thread count (``DPX_TORCH_THREADS``):
    a host's contention swings torch's CPU step time from run to
    run; a fixed count keeps the denominator comparable across runs
    even when the host is busy."""
    if n is None:
        n = int(_env().get("DPX_TORCH_THREADS"))
    try:
        torch.set_num_threads(n)
    except RuntimeError:
        pass  # already started threading: keep whatever it has
