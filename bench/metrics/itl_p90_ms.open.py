"""`itl_p90_ms` where it is no end-to-end metric: in an open loop the 90th
percentile of the gaps between tokens sits between the modes of a
decode-only step, a step with one prefill and one with two, and one seed
read twice lands in either.  The same percentile over the same gaps."""

from harness.stats import gaps_in, percentile


def read(ctx):
    gaps = [g for r in ctx.requests for g in gaps_in(r.stamps, ctx.t0,
                                                     ctx.t_close)]
    return percentile(gaps, 90) * 1e3 if gaps else None
