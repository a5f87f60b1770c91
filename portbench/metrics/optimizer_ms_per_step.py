"""optimizer_ms_per_step (``.train``, ``.ddp``: rank 0 of a
data-parallel cell): device milliseconds per traced step of the kernels
classed ``optimizer`` by the yardstick's kernel-name classes."""

CLASS = "optimizer"


def read(ctx, trace):
    if ctx.get("kind") != "train" or trace is None \
            or not trace.launches_of(CLASS):
        return None
    return 1e3 * trace.seconds_of(CLASS) / ctx["traced_steps"]
