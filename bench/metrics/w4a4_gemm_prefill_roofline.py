"""The W4A4 GEMM kernels' share of their roofline in prefill: each call's
bound at the prompt's real tokens (padding is no work), over the device
time of the ``w4a4`` kernels in the traced prefill calls."""

from harness.readers import device_s, prefill_calls
from roofline.counts import layer_gemms


def read(ctx):
    bound = spent = 0.0
    for n, _, ops in prefill_calls(ctx):
        t = device_s(ops, "w4a4")
        if t:
            bound += ctx.dims["L"] * layer_gemms(ctx.dims, n)[0]
            spent += t
    return 100.0 * bound / spent if spent else None
