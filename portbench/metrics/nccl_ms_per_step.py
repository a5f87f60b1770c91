"""nccl_ms_per_step (``.ddp``): device milliseconds per traced step of
the NCCL kernels on rank 0 (the gradient all-reduce and the window's
stop flag), by the yardstick's kernel-name classes."""

CLASS = "nccl"


def read(ctx, trace):
    if ctx.get("kind") != "train" or trace is None \
            or not trace.launches_of(CLASS):
        return None
    return 1e3 * trace.seconds_of(CLASS) / ctx["traced_steps"]
