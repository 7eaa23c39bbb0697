"""One run of one cell: build, warm up, drive the window, read the metrics,
check the served tokens.

The harness owns the loop.  It submits each request when it is due by its
own clock (`time.perf_counter`, which the engine is also given as its
clock), steps the engine, and stamps every token of every request when the
`step()` that emitted it returns.  A step's tokens reach the caller only
then, so that is when a user would see them.

Set-up is everything from the process's start to the window's: the
weights drawn and packed, every step shape this cell's traffic uses
captured (`InferenceEngine.warmup`), and for a closed batch the first
step, which admits and prefills the first batch.  Nothing is captured
inside the window: `recompiles_steady_state` says so.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

from reference.masters import dims

from . import check, layers, manifest, trace, traffic
from .build import build_engine

#: the last seconds of the window that a traced run profiles
TRACE_S = 3.0
#: how long after the window's close the harness waits for the first token
#: of a request that was due inside it, and then for a prefill and a decode
#: step to tap
DRAIN_S = 60.0


@dataclasses.dataclass
class Rec:
    """One request as the client sees it."""
    idx: int
    due: float                      # the harness clock's second it is due
    prompt: object
    max_new: int
    rid: int = -1
    submit: Optional[float] = None
    req: object = None              # the engine's Request
    stamps: List[float] = dataclasses.field(default_factory=list)

    @property
    def tokens(self) -> List[int]:
        return list(self.req.tokens) if self.req is not None else []

    @property
    def finished(self) -> bool:
        return self.req is not None and self.req.t_finish is not None

    @property
    def ok(self) -> bool:
        return self.finished and self.req.outcome == "ok"


@dataclasses.dataclass
class StepRec:
    start: float
    end: float
    prefills: List[int]             # real tokens of each prefill
    decode_rows: int
    decode_ctx: int                 # keys attended, summed over the rows
    in_window: bool
    traced: bool

    @property
    def has_prefill(self) -> bool:
        return bool(self.prefills)


@dataclasses.dataclass
class Context:
    """What the metric readers read."""
    config: Dict
    dims: Dict
    requests: List[Rec]
    steps: List[StepRec]
    t0: float
    t_close: float
    setup_s: float
    counts: Dict                    # engine counters over the window
    trace: Optional[trace.Trace]

    @property
    def window_s(self) -> float:
        return self.t_close - self.t0

    def window_steps(self) -> List[StepRec]:
        return [s for s in self.steps if s.in_window]

    def due_in_window(self) -> List[Rec]:
        return [r for r in self.requests
                if r.submit is not None and r.due <= self.t_close]


class _Ranged:
    """A step function of the engine called inside a named host range."""

    def __init__(self, fn, name: str):
        self.fn, self.name = fn, name

    def __call__(self, *args):
        from torch.profiler import record_function

        with record_function(self.name):
            return self.fn(*args)

    def __getattr__(self, key):
        return getattr(self.fn, key)


def _ranges(on: bool):
    if not on:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function


def _sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


class Client:
    """The client side of the run: submits, steps, stamps."""

    def __init__(self, engine, api, items, clock, ranges):
        self.engine, self.api, self.clock = engine, api, clock
        self.range = ranges
        self.recs = [Rec(i, 0.0, it.prompt, it.max_new)
                     for i, it in enumerate(items)]
        self.items = items
        self.by_rid: Dict[int, Rec] = {}
        self.steps: List[StepRec] = []
        self.next = 0

    def submit(self, i: int, due: float) -> None:
        rec = self.recs[i]
        rec.due = due
        with self.range("submit"):
            rec.rid = self.api.submit(rec.prompt, rec.max_new)
        rec.submit = self.clock()
        rec.req = self.engine.scheduler.waiting[-1]
        if rec.req.rid != rec.rid:
            raise RuntimeError("the engine queued another request than the "
                               "one submitted")
        self.by_rid[rec.rid] = rec

    def step(self, in_window: bool, traced: bool) -> StepRec:
        eng = self.engine
        sch = eng.scheduler
        pre_fill = bool(sch.waiting) and len(sch.running) < eng.sv.max_batch
        label = trace.STEP_RANGES[1] if pre_fill else trace.STEP_RANGES[0]
        n_pre, n_dec = eng.n_prefill_tokens, eng.n_decode_tokens
        t = self.clock()
        with self.range(label):
            self.api.step()
        end = self.clock()
        with self.range("collect"):
            done = self.api.collect()
        prefills, rows, ctx = [], 0, 0
        for req in list(sch.running.values()) + done:
            rec = self.by_rid.get(req.rid)
            if rec is None:
                continue
            before, after = len(rec.stamps), len(req.tokens)
            if after == before:
                continue
            rec.stamps.extend([end] * (after - before))
            new = after - before
            if before == 0:
                prefills.append(len(req.prompt))
                new -= 1
            if new > 0:
                rows += 1
                ctx += len(req.prompt) + after - 1
        if eng.n_prefill_tokens - n_pre != sum(prefills):
            # a prefix hit prefilled only a tail: the engine's count of the
            # tokens it computed holds; spread it over the prefills
            total = eng.n_prefill_tokens - n_pre
            prefills = [total // len(prefills)] * len(prefills) \
                if prefills else []
        if eng.n_decode_tokens - n_dec != rows:
            raise RuntimeError(
                f"decode rows seen {rows}, engine's count "
                f"{eng.n_decode_tokens - n_dec}")
        rec = StepRec(t, end, prefills, rows, ctx, in_window, traced)
        self.steps.append(rec)
        return rec

    def submit_due(self, t0: float, until: float) -> None:
        while self.next < len(self.items) and \
                t0 + self.items[self.next].due_s <= until:
            self.submit(self.next, t0 + self.items[self.next].due_s)
            self.next += 1

    @property
    def idle(self) -> bool:
        sch = self.engine.scheduler
        return not sch.running and not sch.waiting


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        man: Optional[Dict] = None, **kw) -> Dict:
    """One run of the cell named in the manifest: its configuration,
    traffic, limits and metrics found by name (`execute`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest.load() if man is None else man
    cell = manifest.cell(man, cell_name)
    names = (manifest.per_layer(man, cell_name) if traced
             else manifest.end_to_end(man, cell_name))
    return execute(cell, manifest.config(man, cell["config"]),
                   manifest.traffic(cell["traffic"]),
                   manifest.limits(cell_name), names, seed, seconds, traced,
                   device, t_start, **kw)


def execute(cell: Dict, cfgfile: Dict, mix: Dict, limits: Dict,
            metric_names: List[Dict], seed: int, seconds: float,
            traced: bool, device: str, t_start: float,
            fault: Optional[Callable] = None, controls: tuple = (),
            out: Callable = print) -> Dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device`` and, traced, ``breakdown``) and the
    comparison's numbers under ``check``.  `fault` (tests) receives the
    engine before the window and may break the timed path underneath;
    `controls` (the control's runs) are lower precisions the reference
    also reads the sample in, under ``controls``; `out` takes the lines
    printed before the result."""
    import torch

    clock = time.perf_counter
    model = manifest.as_run(cfgfile)
    d = dims(model)
    items = traffic.generate(mix, seed, d["V"], seconds)
    stored = getattr(torch, cfgfile["serving"]["compute_dtype"])

    engine, api = build_engine(cfgfile, seed, clock, device)
    if fault is not None:
        fault(engine)
    reader = layers.Reader(model, seed, stored, controls)
    taps = layers.install(engine, reader)
    engine.warmup(traffic.prompt_lengths(items))
    ranges = _ranges(traced)
    if traced:
        for name, label in (("_prefill", "prefill call"),
                            ("_prefill_tail", "prefill call"),
                            ("_decode", "decode call")):
            fn = getattr(engine, name, None)
            if fn is not None:
                setattr(engine, name, _Ranged(fn, label))
    drv = Client(engine, api, items, clock, ranges)
    closed = mix["loop"] == "closed"
    if closed:
        now = clock()
        for i in range(len(items)):
            drv.submit(i, now)
        drv.next = len(items)
        if mix.get("admit_in_setup"):
            drv.step(False, False)
    _sync(device)
    recompiles_setup = engine.stats()["recompiles"]["total"]
    counts0 = (engine.n_decode_tokens, engine.n_prefill_tokens,
               engine.n_prefix_hit_tokens)

    if traced:
        # the profiler's first start initialises the device tracer for
        # seconds: paid here, in set-up, and not inside the window
        from torch.profiler import ProfilerActivity, profile
        first = profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
        first.start()
        first.stop()
    t0 = clock()
    setup_s = t0 - t_start
    t_end = t0 + seconds
    t_trace = t_end - min(TRACE_S, seconds / 2)
    prof = None
    while True:
        now = clock()
        if now >= t_end:
            break
        if traced and prof is None and now >= t_trace:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            out(f"profiler started in {clock() - now:.3f} s")
        if not closed:
            drv.submit_due(t0, now)
        if drv.idle:
            if drv.next >= len(items):
                break
            time.sleep(max(0.0, min(t0 + items[drv.next].due_s, t_end)
                           - clock()))
            continue
        drv.step(True, prof is not None)
    # the window ends at its length, or with the step running then
    window_steps = [s for s in drv.steps if s.in_window]
    t_close = max([t_end] + [s.end for s in window_steps[-1:]])
    events = None
    if prof is not None:
        _sync(device)
        prof.stop()
        events = trace.activities(prof)
    counts = {"decode_tokens": engine.n_decode_tokens - counts0[0],
              "prefill_tokens": engine.n_prefill_tokens - counts0[1],
              "prefix_hit_tokens": engine.n_prefix_hit_tokens - counts0[2]}
    recompiles = engine.stats()["recompiles"]["total"] - recompiles_setup

    # every request due inside the window gets its first token, however
    # late (the wait counts in its latency), while arrivals go on as they
    # would
    give_up = clock() + DRAIN_S
    while not closed and clock() < give_up:
        drv.submit_due(t0, clock())
        if not any(r.due <= t_close and not r.stamps
                   for r in drv.recs[:drv.next]):
            break
        if drv.idle:
            time.sleep(0.001)
            continue
        drv.step(False, False)
    _sync(device)
    from repro_torch.kernels import ops
    launches = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)

    # then the comparison's samples: layer 0 of the pool at the first step
    # boundary with live requests, and the next prefill and decode steps,
    # tapped (`layers`)
    held = _held(engine, drv, mix, seed)
    for tap in taps.values():
        tap.armed = True
    give_up = clock() + DRAIN_S
    while not (held and reader.done) and clock() < give_up:
        if not closed:
            drv.submit_due(t0, clock())
        if drv.idle:
            if closed or drv.next >= len(items):
                break
            time.sleep(max(0.0, min(t0 + items[drv.next].due_s, give_up)
                           - clock()))
            continue
        drv.step(False, False)
        if not held:
            held = _held(engine, drv, mix, seed)
    _sync(device)

    tr = None
    if events is not None:
        traced_steps = [s for s in drv.steps if s.traced]
        tr = trace.read(events, traced_steps)
        del events
    ctx = Context(cfgfile, d, drv.recs, drv.steps, t0, t_close, setup_s,
                  counts, tr)
    metrics = _metrics(metric_names, ctx)
    attempted, failed = _outcomes(ctx, closed)
    out(f"cell {cell['name']} seed {seed}: window {ctx.window_s:.3f} s, "
        f"{len(ctx.window_steps())} steps, counts {counts}, "
        f"attempted {attempted}, failed {failed}")
    out(f"latency {_latency(ctx)}")
    out(f"recompiles_steady_state {recompiles} (captures in the window); "
        f"set-up captures {recompiles_setup}")
    out(f"launch counts {launches}")

    # finished requests, the longest in the sample; where the window
    # finished fewer (long outputs), the live ones that were served most
    n_check = int(mix["check_requests"])
    served = lambda r: len(r.req.tokens)  # noqa: E731
    finished = check.sample([r for r in drv.recs if r.ok], n_check, seed,
                            served, 3)
    if len(finished) < n_check:
        finished += check.sample(
            [r for r in drv.recs if r.req is not None and not r.finished
             and len(r.req.tokens) >= 2], n_check - len(finished), seed,
            served, 5)
    # the program's state is freed before the rest of the reference runs
    del engine, api, drv, taps
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    gaps = check.logit_gaps(model, seed, finished, device)
    readings = {"kv0_rel_err": check.kv0_error(model, seed, held, device,
                                               stored),
                **layers.compared(reader.readings),
                "max_logit_gap": gaps["max"],
                "median_logit_gap": gaps["median"],
                "median_rank_share": gaps["rank_share"],
                "p90_rank_share": gaps["rank_share_p90"],
                "tokens_checked": gaps["tokens"],
                "out_of_vocab": gaps["out_of_vocab"]}
    out(f"readings {readings} over {len(held)} live and "
        f"{len(finished)} finished requests; tapped {reader.readings}")
    verdict = check.judge(readings, limits)
    result = {"correct": verdict["correct"], "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": _device(device, peak, tr)}
    if tr is not None:
        result["breakdown"] = {"device_ops": trace.top_ops(tr),
                               "idle_gaps": trace.top_gaps(tr)}
    if controls:
        result["readings"] = readings
        result["controls"] = {}
        for act in controls:
            g = check.logit_gaps(model, seed, finished, device, act)
            result["controls"][str(act)] = {
                "kv0_rel_err": check.kv0_error(model, seed, held, device,
                                               stored, act),
                **layers.compared(reader.controls[str(act)]),
                "max_logit_gap": g["max"], "median_logit_gap": g["median"],
                "median_rank_share": g["rank_share"],
                "p90_rank_share": g["rank_share_p90"]}
    result["check"] = verdict["numbers"]
    return result


def _held(engine, drv, mix: Dict, seed: int) -> List[Dict]:
    """Layer 0 of the pool for a sample of the live requests (the longest
    always in it), or [] when none is live."""
    running = engine.scheduler.running
    live = [r for r in drv.recs if r.req is not None
            and r.req.rid in running and r.req.n_cached > 0]
    return check.pool_layer0(engine, check.sample(
        live, int(mix["check_requests"]), seed, lambda r: r.req.n_cached, 4))


def _metrics(names: List[Dict], ctx: Context) -> Dict:
    out = {}
    for m in names:
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _latency(ctx: Context) -> Dict:
    """Percentiles (ms) of the time to first token over the requests due in
    the window and of the gaps between tokens, printed beside the metrics
    so that a steadier statistic can be read from the same runs."""
    from .stats import gaps_in, percentile

    ttft = [r.stamps[0] - r.due for r in ctx.due_in_window() if r.stamps]
    gaps = [g for r in ctx.requests
            for g in gaps_in(r.stamps, ctx.t0, ctx.t_close)]
    out = {"requests": len(ttft), "gaps": len(gaps)}
    for name, xs in (("ttft", ttft), ("itl", gaps)):
        for q in (50, 75, 90, 95, 99):
            v = percentile(xs, q)
            out[f"{name}_p{q}"] = None if v is None else v * 1e3
    return out


def _outcomes(ctx: Context, closed: bool):
    """(attempted, failed): closed, the requests that got a token by the
    window's close; open, every request due inside the window, failed when
    it never got its first token or retired otherwise than ok."""
    if closed:
        tried = [r for r in ctx.requests
                 if r.stamps and r.stamps[0] <= ctx.t_close]
    else:
        tried = ctx.due_in_window()
    failed = [r for r in tried
              if not r.stamps or (r.finished and not r.ok)]
    return len(tried), len(failed)


def _device(device: str, peak: int, tr) -> Dict:
    import torch
    if device.startswith("cuda"):
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    return dev
