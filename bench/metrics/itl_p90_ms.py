"""90th percentile of every gap between consecutive tokens of a request
whose later token falls in the window, over all requests."""

from harness.stats import gaps_in, percentile


def read(ctx):
    gaps = [g for r in ctx.requests for g in gaps_in(r.stamps, ctx.t0,
                                                     ctx.t_close)]
    return percentile(gaps, 90) * 1e3 if gaps else None
