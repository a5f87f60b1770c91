"""train_mfu (``train_mfu.ddp``: a data-parallel cell): model FLOPs of
every step in the window (3x the forward's, no recompute counted, over
all ranks) over the window's host-clock seconds and the bf16 peak of
every card the cell uses, in %."""

from portbench import yardstick


def read(ctx, trace):
    if ctx.get("kind") != "train":
        return None
    try:
        peak = yardstick.peaks(ctx["device_kind"])[0]
    except ValueError:
        return None
    done = ctx["flops_per_step"] * ctx["steps"]
    return 100.0 * done / ctx["window_s"] / (peak * ctx["chips"])
