"""loader_ms_per_step (``.train``, ``.ddp``: rank 0 of a data-parallel
cell): host milliseconds per window step spent in the benchmark's span
around the next batch from the port's loader and its copy to the device."""


def read(ctx, trace):
    if ctx.get("kind") != "train" or not ctx.get("loader_s"):
        return None
    return 1e3 * sum(ctx["loader_s"]) / len(ctx["loader_s"])
