"""serve_tpot_p95_ms: each request's mean gap between streamed tokens
after its first, 95th percentile over the requests sent in the window
that streamed two tokens or more."""

from portbench import yardstick


def read(ctx, trace):
    if ctx.get("kind") != "serve" or not ctx.get("tpot_s"):
        return None
    return 1e3 * yardstick.percentile(ctx["tpot_s"], 95)
