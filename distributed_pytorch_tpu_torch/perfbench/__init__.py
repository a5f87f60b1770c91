"""perfbench: the variance-gated trial statistics of the port.

Counterpart of ``distributed_pytorch_tpu/perfbench/``; only
:mod:`.stats` is ported so far (warmup-discarded repeated trials,
median + IQR, the spread gate, :func:`~.stats.gated_ratio`, CPU and
thread pinning on request). Nothing is pinned at import.
"""

from . import stats  # noqa: F401
from .stats import (TrialStats, gated_ratio, measure,  # noqa: F401
                    measure_until, summarize)

__all__ = ["stats", "TrialStats", "gated_ratio", "measure",
           "measure_until", "summarize"]
