"""The 90th percentile, over every request due in the window, of its
first token's stamp less the second it was due.  A request that never got a
token counts as waiting until the harness gave up on it."""

from harness.cell import DRAIN_S
from harness.stats import percentile


def read(ctx):
    due = ctx.due_in_window()
    if not due:
        return None
    give_up = ctx.t_close + DRAIN_S
    lat = [(r.stamps[0] if r.stamps else give_up) - r.due for r in due]
    return percentile(lat, 90) * 1e3
