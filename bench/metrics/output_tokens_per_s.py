"""Every token stamped inside the window, over the window's seconds."""

from harness.stats import tokens_in


def read(ctx):
    n = sum(tokens_in(r.stamps, ctx.t0, ctx.t_close) for r in ctx.requests)
    return n / ctx.window_s
