"""other_ms_per_step (``.train``, ``.ddp``: rank 0 of a data-parallel
cell): device milliseconds per traced step of the kernels classed
``other`` by the yardstick's kernel-name classes."""

CLASS = "other"


def read(ctx, trace):
    if ctx.get("kind") != "train" or trace is None \
            or not trace.launches_of(CLASS):
        return None
    return 1e3 * trace.seconds_of(CLASS) / ctx["traced_steps"]
