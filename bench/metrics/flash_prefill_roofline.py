"""The flash prefill kernel's share of its roofline: each layer's causal
prefill of the prompt's real tokens (padding is no work) over the device
time of ``flash_prefill`` kernels in the traced prefill calls."""

from harness.readers import device_s, prefill_calls
from roofline.counts import PEAKS, bound_s, flash_prefill


def read(ctx):
    bound = spent = 0.0
    for n, _, ops in prefill_calls(ctx):
        t = device_s(ops, "flash_prefill")
        if t:
            o, b = flash_prefill(ctx.dims, n)
            bound += ctx.dims["L"] * bound_s(o, b, PEAKS["bf16_flop_per_s"])
            spent += t
    return 100.0 * bound / spent if spent else None
