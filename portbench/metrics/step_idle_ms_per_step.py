"""step_idle_ms_per_step (``.train``): device idle milliseconds per
traced step while the program's ``dpx.dp_step`` range was open on the
host (``portbench.phases``, at each idle gap's midpoint). None without
the program's phase ranges, or from a data-parallel rank's reduced
record. Its entry lists ``gpt2-small.train`` alone: on ``gpt2-xl.train``
a traced step's idle is mostly the profiler's own host cost on its
thousands of launches, which no untraced step pays."""

from portbench import phases


def read(ctx, trace):
    return phases.idle_ms_per_step(ctx, trace, "dp_step")
