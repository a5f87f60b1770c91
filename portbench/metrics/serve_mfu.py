"""serve_mfu: forward FLOPs of every prompt token prefilled and every
output token decoded in the window, each at its own context (the
yardstick's ``forward_flops_at``), over the window's seconds and the
card's bf16 peak, in %."""

from portbench import yardstick


def read(ctx, trace):
    if ctx.get("kind") != "serve":
        return None
    try:
        peak = yardstick.peaks(ctx["device_kind"])[0]
    except ValueError:
        return None
    return 100.0 * ctx["window_flops"] / ctx["window_s"] / peak
