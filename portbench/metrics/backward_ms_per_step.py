"""backward_ms_per_step (``.train``): device milliseconds per traced step
of the operations launched while the program's ``dpx.backward`` range
was open (``portbench.phases``: one card, launches matched to device
operations by order). None without the program's phase ranges."""

from portbench import phases


def read(ctx, trace):
    return phases.device_ms_per_step(ctx, trace, "backward")
