"""serve_ttft_p95_ms: the client's submit to its first streamed token,
95th percentile over every request sent in the window (a request that
failed counts as infinitely late, and an infinite percentile is not
reported)."""

import math

from portbench import yardstick


def read(ctx, trace):
    if ctx.get("kind") != "serve" or not ctx.get("ttft_s"):
        return None
    p95 = yardstick.percentile(ctx["ttft_s"], 95)
    return 1e3 * p95 if math.isfinite(p95) else None
