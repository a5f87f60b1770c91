"""flash_fwd_roofline (``.train``, ``.ddp``: rank 0 of a data-parallel
cell): the flash forward launches of the traced steps, their summed
least time (the yardstick's ``flash_cost`` at the step's (batch, heads,
seq, head_dim), bf16, causal) over their summed device time, in %."""

from portbench import yardstick


def read(ctx, trace):
    if ctx.get("kind") != "train" or trace is None:
        return None
    n, t = trace.launches_of("flash_fwd"), trace.seconds_of("flash_fwd")
    if not n or not t > 0:
        return None
    b, h, s, d = ctx["batch"], ctx["heads"], ctx["seq"], ctx["head_dim"]
    try:
        bound = yardstick.bound_s(*yardstick.flash_cost(b, h, h, s, s, d, 2),
                                  ctx["device_kind"])
    except ValueError:
        return None
    return 100.0 * n * bound / t
