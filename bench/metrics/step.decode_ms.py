"""Host-clock milliseconds of an engine step that held no prefill: the
total of the window's decode-only steps over their count."""


def read(ctx):
    steps = [s for s in ctx.window_steps()
             if s.decode_rows and not s.has_prefill]
    if not steps:
        return None
    return sum(s.end - s.start for s in steps) / len(steps) * 1e3
