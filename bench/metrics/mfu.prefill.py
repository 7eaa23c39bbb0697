"""The whole prefill's share of the chip's peak: the operations of the real
prompt tokens prefilled (from the configuration's shapes) at the peaks,
over the traced prefill calls' time, each from its call to the next (its
token readback inside)."""

from harness.readers import prefill_calls
from roofline.counts import prefill_at_peak


def read(ctx):
    work = wall = 0.0
    for n, ns, _ in prefill_calls(ctx):
        work += prefill_at_peak(ctx.dims, n)
        wall += ns / 1e9
    return 100.0 * work / wall if wall else None
