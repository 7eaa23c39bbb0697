"""The whole decode step's share of the chip's peak: the operations of the
rows served (W4A4 projections at the int8 rate, attention and the lm_head
at the bfloat16 rate, from the configuration's shapes) at those peaks,
over the host-clock time of the window's decode-only steps."""

from roofline.counts import decode_step_at_peak


def read(ctx):
    steps = [s for s in ctx.window_steps()
             if s.decode_rows and not s.has_prefill]
    if not steps:
        return None
    work = sum(decode_step_at_peak(ctx.dims, s.decode_rows, s.decode_ctx)
               for s in steps)
    return 100.0 * work / sum(s.end - s.start for s in steps)
