"""What the metric readers share: the traced step functions' calls with
their device operations, and each call's real work."""

from __future__ import annotations

from typing import Iterator, List, Tuple


def calls(ctx, label: str) -> Iterator[Tuple[object, int, int, List]]:
    """(step record, call start ns, call end ns, device ops) of every
    traced call named `label`; a call ends where the next begins, or with
    its step (its token readback inside)."""
    tr = ctx.trace
    if tr is None:
        return
    by = {}
    for op in tr.ops:
        if op.step is not None and op.call is not None:
            by.setdefault((op.step, op.call), []).append(op)
    for i, s in enumerate(tr.steps):
        for j, (name, a, _) in enumerate(s.calls):
            if name != label:
                continue
            end = s.calls[j + 1][1] if j + 1 < len(s.calls) else s.end
            yield s.record, a, end, by.get((i, j), [])


def prefill_calls(ctx) -> Iterator[Tuple[int, int, List]]:
    """(real tokens, wall ns, device ops) of every traced prefill, matched
    in order to the prefills the harness counted in its step."""
    seen = {}
    for rec, a, b, ops in calls(ctx, "prefill call"):
        k = seen.get(id(rec), 0)
        seen[id(rec)] = k + 1
        if k < len(rec.prefills):
            yield rec.prefills[k], b - a, ops


def decode_calls(ctx) -> Iterator[Tuple[int, int, int, List]]:
    """(real rows, keys attended, wall ns, device ops) of every traced
    decode call."""
    for rec, a, b, ops in calls(ctx, "decode call"):
        if rec.decode_rows:
            yield rec.decode_rows, rec.decode_ctx, b - a, ops


def device_s(ops: List, pattern: str) -> float:
    """Seconds of the device operations whose name holds `pattern`."""
    return sum(op.end - op.start for op in ops if pattern in op.name) / 1e9
