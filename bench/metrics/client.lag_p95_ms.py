"""How late the load generator ran: 95th percentile, over every request due
in the window, of its submit less the second it was due."""

from harness.stats import percentile


def read(ctx):
    lag = [r.submit - r.due for r in ctx.due_in_window()]
    return percentile(lag, 95) * 1e3 if lag else None
