"""The paged decode attention kernel's share of its roofline: each layer's
bound (the rows' queries and every key and value of their contexts, read
once) over the device time of ``paged_decode`` kernels in the traced
decode calls."""

from harness.readers import decode_calls, device_s
from roofline.counts import PEAKS, bound_s, paged_decode


def read(ctx):
    cache = ctx.config["serving"]["cache_dtype"]
    bound = spent = 0.0
    for rows, keys, _, ops in decode_calls(ctx):
        t = device_s(ops, "paged_decode")
        if t:
            o, b = paged_decode(ctx.dims, rows, keys, cache)
            bound += ctx.dims["L"] * bound_s(o, b, PEAKS["bf16_flop_per_s"])
            spent += t
    return 100.0 * bound / spent if spent else None
