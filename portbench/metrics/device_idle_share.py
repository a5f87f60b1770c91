"""device_idle_share (``.train``, ``.serve``, ``.ddp``): the share of
the traced window in which no operation ran on the device, in % (in a
data-parallel cell the ranks' mean busy and window seconds)."""


def read(ctx, trace):
    if trace is None or not trace.busy_s > 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
