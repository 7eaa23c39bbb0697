"""Real rows a decode step ran over the window (the engine's decode-token
count over the steps that decoded)."""


def read(ctx):
    steps = [s for s in ctx.window_steps() if s.decode_rows]
    return ctx.counts["decode_tokens"] / len(steps) if steps else None
