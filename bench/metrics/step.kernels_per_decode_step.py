"""Device kernels a decode-only step ran, from the profiler's trace: the
kernels inside the traced decode-only steps over their count."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    idx = [i for i, s in enumerate(tr.steps)
           if s.record.decode_rows and not s.record.has_prefill]
    if not idx:
        return None
    keep = set(idx)
    n = sum(1 for op in tr.ops if op.kind == "kernel" and op.step in keep)
    return n / len(idx)
