"""90th percentile, over every request due in the window, of the engine's
admission stamp (``Request.t_admit``, on the harness's clock) less the
second it was due; a request never admitted waits until the harness gave
up on it."""

from harness.cell import DRAIN_S
from harness.stats import percentile


def read(ctx):
    due = ctx.due_in_window()
    if not due:
        return None
    give_up = ctx.t_close + DRAIN_S
    wait = [(r.req.t_admit if r.req.t_admit is not None else give_up)
            - r.due for r in due]
    return percentile(wait, 90) * 1e3
