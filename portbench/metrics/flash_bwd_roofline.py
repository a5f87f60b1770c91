"""flash_bwd_roofline (``.train``, ``.ddp``: rank 0 of a data-parallel
cell): the dK/dV and dQ launches of the traced steps, their summed least
times (the yardstick's ``flash_bwd_cost`` at the step's shapes, bf16,
causal) over their summed device time, in %."""

from portbench import yardstick


def read(ctx, trace):
    if ctx.get("kind") != "train" or trace is None:
        return None
    b, h, s, d = ctx["batch"], ctx["heads"], ctx["seq"], ctx["head_dim"]
    cost = yardstick.flash_bwd_cost(b, h, h, s, s, d, 2)
    bound = t = 0.0
    for part in ("dkv", "dq"):
        cls = f"flash_bwd_{part}"
        try:
            one = yardstick.bound_s(*cost[part], ctx["device_kind"])
        except ValueError:
            return None
        bound += trace.launches_of(cls) * one
        t += trace.seconds_of(cls)
    if not t > 0:
        return None
    return 100.0 * bound / t
