"""The W4A4 GEMM kernels' share of their roofline in decode: the sum of
each call's bound (every layer's projections at the decode's real rows)
over the device time of the ``w4a4`` kernels in the traced decode calls."""

from harness.readers import decode_calls, device_s
from roofline.counts import layer_gemms


def read(ctx):
    bound = spent = 0.0
    for rows, _, _, ops in decode_calls(ctx):
        t = device_s(ops, "w4a4")
        if t:
            bound += ctx.dims["L"] * layer_gemms(ctx.dims, rows)[0]
            spent += t
    return 100.0 * bound / spent if spent else None
