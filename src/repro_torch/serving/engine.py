"""Inference engine: runs the serving steps over the scheduled batch with
per-request state tracking and latency/throughput stats (PyTorch port of
``repro/serving/engine.py``, paged layout, both step modes).

One `step()` is a decode-step boundary.  Bucketed (``sv.step ==
"bucketed"``): admit (+ prefill) newly arrived requests, preempt if the
page pool is dry, run one decode step for the running set, retire finished
requests.  Ragged (``"ragged"``): admit, plan a token budget's worth of
work (decode tokens first, then prefill chunks, ``Scheduler.plan_tokens``),
run one step over the flat pack, retire.  Greedy decoding.

The pool and the block-table pool ``[max_batch, pages_per_seq]`` live on
the device.  Table rows move host->device only when a request is admitted
or its page allocation grows, never per step; the steps gather the batch's
rows on the device.  Decode batches pad to the nearest bucket with inactive
rows (position -1: attention masks them, their KV writes go to the pool's
spill page), prompts left-pad to a power-of-two bucket.

Device policy: the engine runs on ``cuda`` unless the caller passes
``device="cpu"``, and raises when no GPU is present and the CPU was not
asked for.  On CUDA every kernel-backed op launches its CUDA kernel; on the
CPU the kernels' plain versions run.

Compiled steps: on CUDA each step (prefill, tail prefill, decode, ragged)
is a ``launch.steps.CapturedStep``, one CUDA graph per step shape, as the
JAX engine jits each step once per bucket; on the CPU the steps run
eagerly.  A recompile sentinel (``observability.jit_watch``) is polled
after every step call, warmup included, and counts the captures per step
function and shape (on the CPU, each new shape); ``stats()["recompiles"]``
reports them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.quant_plan import pack_for_serving
from ..launch.steps import (CapturedStep, cuda_graph_capture,
                            make_ragged_step, make_serving_steps)
from ..models.transformer import init_model, with_layer_views
from ..observability import Telemetry
from ..observability.metrics import COUNT_BUCKETS, MetricsRegistry
from .kv_pages import PagedKVCacheManager, init_paged_caches
from .scheduler import ERROR, OK, SHED, Request, Scheduler, ShedError


#: the step functions, as the engine's attributes (``_<name>``) and the
#: recompile sentinel's function names
STEP_NAMES = ("prefill", "prefill_tail", "decode", "ragged")


class EngineStuckError(RuntimeError):
    """run_until_idle() exhausted its step budget with work still queued
    or running."""


def resolve_device(device) -> torch.device:
    """The serving device: ``cuda`` unless the caller asks for the CPU;
    raises when CUDA is asked for and no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def build_params(cfg, rt, seed: int = 0, device="cuda"):
    """Init random f32 serving weights from a seeded ``torch.Generator`` on
    `device` and, for the pre-packing sites of the active plan (any plan:
    ``Runtime.quant_plan`` or ``quant_backend``), pack them (int4 nibbles +
    scales + the kernel's planar K-major twin).  Every other site keeps its
    f32 master, which the on-the-fly backends quantize per call."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return pack_for_serving(init_model(gen, cfg), cfg, rt)


class InferenceEngine:
    """submit() requests, step() the world, collect() finished requests."""

    def __init__(self, cfg, rt, sv, params=None, seed: int = 0,
                 clock=time.time, metrics: Optional[MetricsRegistry] = None,
                 device="cuda", telemetry: Optional[Telemetry] = None):
        if sv.layout != "paged":
            raise NotImplementedError(
                f"only the paged layout is ported (got {sv.layout!r})")
        self.cfg, self.rt, self.sv = cfg, rt, sv
        self.device = resolve_device(device)
        self.clock = clock
        # metrics registry + recompile sentinel (`metrics` alone keeps the
        # sentinel counting into that registry)
        self.tm = telemetry if telemetry is not None \
            else Telemetry(registry=metrics)
        self.metrics = self.tm.registry
        if params is None:
            params = build_params(cfg, rt, seed, self.device)
        self.params = with_layer_views(params, cfg)

        self.kv = PagedKVCacheManager(sv, metrics=self.metrics)
        self.caches = init_paged_caches(cfg, rt, sv, device=self.device)
        # rows start at the sentinel (== num_pages): writes through an
        # unassigned slot go to the spill page, reads are zeros.  Updated in
        # place (`_sync_tables`): one tensor for the engine's lifetime, which
        # the captured steps read where it lies
        self._tbl = torch.full((sv.max_batch, sv.pages_per_seq),
                               sv.num_pages, dtype=torch.int32,
                               device=self.device)
        # rid -> (slot, uploaded page ids): a row re-uploads only when the
        # allocation changed
        self._tbl_ver: Dict[int, tuple] = {}
        self.scheduler = Scheduler(self.kv, sv.max_batch,
                                   metrics=self.metrics,
                                   max_queue=sv.max_queue)
        self._prefill, self._prefill_tail, self._decode = make_serving_steps(
            cfg, rt)
        # ragged token-major step: one step function whose shape is the
        # padded token budget, whatever the batch's mix of prefill chunks
        # and decode tokens
        self._ragged = make_ragged_step(cfg, rt) \
            if sv.step == "ragged" else None
        self._budget = sv.budget
        # recompile sentinel: every step function is polled after each call
        # (warmup included), so a capture is attributed to the bucket shape
        # that triggered it
        for name in STEP_NAMES:
            self.tm.jit_watch.register(name, getattr(self, "_" + name))
        self._captured = False
        if self.device.type == "cuda":
            # one memory pool for every graph of the engine: no graph leaves
            # a tensor alive in it (static inputs and outputs are allocated
            # outside any capture), and the graphs replay one at a time on
            # one stream, so a graph's scratch may reuse another's
            self._capture_steps(
                cuda_graph_capture(torch.cuda.graph_pool_handle()),
                torch.cuda.CUDAGraph)

        self._next_rid = 0
        self._finished: List[Request] = []
        self._all: Dict[int, Request] = {}
        self.n_steps = 0
        self.n_decode_tokens = 0
        self.n_prefill_tokens = 0
        self.n_prefix_hit_tokens = 0
        self.n_tokens_packed = 0
        self.n_tokens_wasted = 0
        self.t_start = None

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _in(self, a: np.ndarray) -> torch.Tensor:
        """A per-step input: on the device for the eager steps; a host
        tensor for the captured steps, which stage it into their graph's
        static buffers."""
        return torch.from_numpy(a) if self._captured else self._dev(a)

    def _capture_steps(self, capture, graph) -> None:
        """Wrap every step in a `CapturedStep` taking `capture` and `graph`
        (``launch.steps.cuda_graph_capture`` and ``torch.cuda.CUDAGraph``
        on CUDA) and watch the wrappers in its place."""
        for name in STEP_NAMES:
            fn = getattr(self, "_" + name)
            if fn is not None:
                step = CapturedStep(fn, self.device, capture, graph)
                setattr(self, "_" + name, step)
                self.tm.jit_watch.register(name, step)
        self._captured = True

    # -------------------------------------------------------------- api --
    def submit(self, prompt, max_new: int, arrival: Optional[float] = None,
               eos_id: Optional[int] = None) -> int:
        """Queue a request.  Raises ShedError when the bounded admission
        queue is full and ValueError when the request can never fit; both
        retire it (outcome shed / error), collectable via collect()."""
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new=max_new,
                      arrival=now if arrival is None else arrival,
                      eos_id=eos_id)
        req.t_visible = now
        self._all[rid] = req
        try:
            self.scheduler.submit(req)
        except (ShedError, ValueError) as exc:
            req.state = "finished"
            req.outcome = SHED if isinstance(exc, ShedError) else ERROR
            req.t_finish = now
            self._finished.append(req)
            self._observe_retire(req)
            raise
        self.metrics.counter("requests_submitted_total",
                             "requests accepted into the queue").inc()
        return rid

    def collect(self) -> List[Request]:
        out, self._finished = self._finished, []
        return out

    def warmup(self, prompt_lens=()) -> None:
        """Run every expected step shape once (one prefill per prompt
        bucket, one decode per batch bucket) before the measured window,
        so first-call costs (kernel loading, allocator growth and, on CUDA,
        the shape's capture) stay out of the stats.  Every position is -1:
        all writes go to the spill page and the pool is untouched.  The
        ragged step has one shape, the token budget, so it warms with one
        call whatever the prompts."""
        if self._ragged is not None:
            self._warm_ragged()
            return
        slot0 = torch.zeros((1,), dtype=torch.int32, device=self.device)
        for L in sorted({self.sv.prompt_bucket(n) for n in prompt_lens}):
            tokens = torch.zeros((1, L), dtype=torch.int32, device=self.device)
            positions = torch.full((1, L), -1, dtype=torch.int32,
                                   device=self.device)
            _, self.caches = self._prefill(self.params, tokens, self.caches,
                                           positions, self._tbl, slot0)
            self._poll_jit("prefill", (1, L))
            if self.sv.prefix_cache:
                # prefix hits run the tail-prefill step over the same
                # buckets (a tail can land in a smaller bucket mid-run; that
                # capture is attributed to the run)
                _, self.caches = self._prefill_tail(
                    self.params, tokens, self.caches, positions, self._tbl,
                    slot0)
                self._poll_jit("prefill_tail", (1, L))
        for nb in self.sv.buckets:
            tok = torch.zeros((nb, 1), dtype=torch.int32, device=self.device)
            pos = torch.full((nb, 1), -1, dtype=torch.int32,
                             device=self.device)
            _, self.caches = self._decode(
                self.params, tok, self.caches, pos, self._tbl,
                torch.zeros((nb,), dtype=torch.int32, device=self.device))
            self._poll_jit("decode", (nb, 1))

    def step(self) -> int:
        """One decode-step boundary; returns the number of running requests
        after the step (0 = idle)."""
        if self._ragged is not None:
            return self._step_ragged()
        return self._step_bucketed()

    def _warm_ragged(self) -> None:
        """One ragged step at the current budget, all rows padding (slot
        and position -1): every write goes to the spill page."""
        T, dev = self._budget, self.device
        pad = torch.full((T,), -1, dtype=torch.int32, device=dev)
        _, self.caches = self._ragged(
            self.params, torch.zeros((1, T), dtype=torch.int32, device=dev),
            self.caches, pad[None], self._tbl, pad,
            torch.full((self.sv.max_batch,), -1, dtype=torch.int32,
                       device=dev))
        self._poll_jit("ragged", (1, T))

    def _grow_budget(self, need: int) -> None:
        """The running set's decode tokens (plus one prefill-chunk row)
        exceed the budget, which only an explicit token_budget below
        max_batch allows: double it until they fit, capture the new shape
        and re-baseline the sentinel.  The growth lands in the compiles
        count, never in steady_state."""
        new = self._budget
        while new < need:
            new *= 2
        self._budget = new
        self.metrics.counter(
            "ragged_budget_grows_total",
            "token-budget doublings of the ragged step").inc()
        self._warm_ragged()
        self.tm.jit_watch.absorb("ragged")

    def _step_bucketed(self) -> int:
        t0 = time.perf_counter()
        now = self.clock()
        if self.t_start is None:
            self.t_start = now
        admitted = self.scheduler.admit(now)
        for req in admitted:
            self._prefill_request(req)
        self._retire()                 # a 1-token request is done at prefill
        self.scheduler.ensure_decode()
        batch = self.scheduler.batch()
        if batch:
            self._decode_batch(batch)
        self.n_steps += 1
        self._retire()
        self._observe_step(t0, batch)
        return len(self.scheduler.running)

    def _step_ragged(self) -> int:
        """One ragged token-major step: admit, plan a token budget's worth
        of work, run one step over the flat pack, apply its emissions.  An
        admitted request's prefix drains through the planner as chunks,
        possibly over several steps, beside everyone else's decode
        tokens."""
        t0 = time.perf_counter()
        now = self.clock()
        if self.t_start is None:
            self.t_start = now
        for req in self.scheduler.admit(now):
            # prefix-cache hits are realized at admission: the planner only
            # ever feeds prefix[n_cached:]
            hit = req.n_cached
            self.n_prefix_hit_tokens += hit
            self.metrics.counter(
                "prefix_hit_tokens_total",
                "prompt/resume tokens served from cached pages").inc(hit)
        self.scheduler.ensure_decode()
        # the budget must cover every decode token plus one prefill-chunk
        # row while a prefill-phase request runs, or a saturated decode set
        # starves the later slots (decode tokens are planned in slot order)
        running = self.scheduler.running.values()
        need = sum(1 for r in running if r.decoding) \
            + (1 if any(not r.decoding for r in running) else 0)
        if need > self._budget:
            self._grow_budget(need)
        plan = self.scheduler.plan_tokens(self._budget)
        if plan:
            self._ragged_exec(plan)
        self.n_steps += 1
        self._retire()
        self._observe_step(t0, [r for r, _, _ in plan if r.decoding])
        return len(self.scheduler.running)

    def _ragged_exec(self, plan) -> None:
        """Pack the planned (req, start, n) chunks into the flat [1, T]
        buffers and run the ragged step.  Every row's K/V is written
        through its block table before attention, so one mask rule (key
        position <= query position) is causal for prefill chunks and
        last-token for decode rows."""
        T = self._budget
        tokens = np.zeros((1, T), np.int32)
        positions = np.full((1, T), -1, np.int32)   # -1 = padding: spilled
        slots = np.full((T,), -1, np.int32)
        emit_rows = np.full((self.sv.max_batch,), -1, np.int32)
        used = 0
        for req, start, n in plan:
            tokens[0, used:used + n] = req.prefix[start:start + n]
            positions[0, used:used + n] = np.arange(start, start + n)
            slots[used:used + n] = req.slot
            if start + n == len(req.prefix):
                # the chunk reaches the prefix's end: its last row's logits
                # give the request's next token (always, for a decode row)
                emit_rows[req.slot] = used + n - 1
            used += n
        self._observe_packing(used, T)
        self._sync_tables([r for r, _, _ in plan])
        nxt, self.caches = self._ragged(
            self.params, self._in(tokens), self.caches,
            self._in(positions), self._tbl, self._in(slots),
            self._in(emit_rows))
        self._poll_jit("ragged", (1, T))
        # the step's one device->host sync: token readback
        nxt = np.asarray(nxt.cpu())  # repro: ignore[host-sync-in-hot-path]
        ps = self.sv.page_size
        m = self.metrics
        for req, start, n in plan:
            end = start + n
            if req.decoding:
                self.n_decode_tokens += 1
                m.counter("decode_tokens_total",
                          "tokens emitted by decode steps").inc()
            else:
                self.n_prefill_tokens += n
                m.counter("prefill_tokens_total",
                          "tokens pushed through prefill").inc(n)
            req.n_cached = end
            if emit_rows[req.slot] >= 0:
                if not req.decoding:
                    # the prefill just completed: index its full pages
                    # before the emitted token joins the prefix
                    self.kv.register_upto(req.rid, req.prefix, end)
                req.tokens.append(int(nxt[req.slot]))
                if req.t_first is None:
                    req.t_first = self.clock()
                req.decoding = True
                if end % ps == 0 and len(req.tokens) > 1:
                    # a decode row filled a generated-token page
                    self.kv.register_upto(req.rid, req.prefix, end)

    def _observe_step(self, t0: float, batch: List[Request]) -> None:
        m = self.metrics
        m.counter("steps_total", "engine decode-step boundaries").inc()
        m.histogram("step_wall_us", "wall time per engine step").observe(
            (time.perf_counter() - t0) * 1e6)
        if batch:
            m.histogram("decode_batch_size", "running rows per decode step",
                        buckets=COUNT_BUCKETS).observe(len(batch))
        m.gauge("queue_depth", "requests waiting for admission").set(
            len(self.scheduler.waiting))
        m.gauge("running_requests", "requests in the decode batch").set(
            len(self.scheduler.running))
        m.gauge("kv_pool_in_use_pages", "pages held by running requests").set(
            self.kv.in_use)
        m.gauge("kv_pool_high_water_pages",
                "peak concurrent in-use pages").set(self.kv.high_water)

    def _retire(self) -> None:
        now = self.clock()
        for req in list(self.scheduler.running.values()):
            if req.done:
                self.scheduler.finish(req, now)
                self._finished.append(req)
                self._observe_retire(req)

    def _observe_retire(self, req: Request) -> None:
        m = self.metrics
        out = req.outcome or ERROR
        m.counter("requests_retired_total", "requests retired, any outcome",
                  outcome=out).inc()
        if out == OK:
            m.counter("requests_finished_total",
                      "requests fully decoded").inc()
        m.histogram("request_latency_us", "submit-to-retire wall time",
                    outcome=out).observe((req.t_finish - req.t_visible) * 1e6)
        if req.t_first is not None:
            m.histogram("ttft_us", "time to first token",
                        outcome=out).observe(
                            (req.t_first - req.t_visible) * 1e6)

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and self.scheduler.idle:
                return
        raise EngineStuckError(
            f"engine not idle after {max_steps} steps: queued rids "
            f"{[r.rid for r in self.scheduler.waiting]}, running rids "
            f"{list(self.scheduler.running)}")

    # -------------------------------------------------------- internals --
    def _poll_jit(self, name: str, shape) -> None:
        """Poll the recompile sentinel right after a step call, attributing
        any new capture to `shape` (the call's bucket signature)."""
        self.tm.jit_watch.after_call(name, shape, step=self.n_steps)

    def _observe_packing(self, used: int, capacity: int) -> None:
        wasted = max(capacity - used, 0)
        self.n_tokens_packed += used
        self.n_tokens_wasted += wasted
        self.metrics.counter(
            "padding_tokens_wasted_total",
            "padding token rows computed and discarded").inc(wasted)

    def _sync_tables(self, batch: List[Request]) -> None:
        """Upload block-table rows whose page allocation changed since the
        last upload (admission, page growth): the only host->device table
        traffic."""
        for req in batch:
            ver = (req.slot, tuple(self.kv.pages.get(req.rid, ())))
            if self._tbl_ver.get(req.rid) != ver:
                self._tbl[req.slot] = self._dev(self.kv.table_row(req.rid))
                self._tbl_ver[req.rid] = ver
                self.metrics.counter(
                    "block_table_uploads_total",
                    "host->device block-table row uploads").inc()
        running = self.scheduler.running
        for rid in [r for r in self._tbl_ver if r not in running]:
            del self._tbl_ver[rid]

    def _prefill_request(self, req: Request) -> None:
        """Prefill a (re-)admitted request's uncached prefix tail (batch of
        one, left-padded to a power-of-two bucket) and emit its first token.
        After a prefix-cache hit (``req.n_cached`` > 0) only the tail runs,
        through the tail-prefill step that attends over the cached pages."""
        prefix = req.prefix
        L = len(prefix)
        hit = req.n_cached                     # page-aligned, < L by design
        tail = prefix[hit:]
        n = len(tail)
        Lb = self.sv.prompt_bucket(n)
        tokens = np.zeros((1, Lb), np.int32)
        tokens[0, Lb - n:] = tail
        base = np.arange(Lb, dtype=np.int32) - (Lb - n)
        # pad rows stay negative (spilled writes, masked queries) after the
        # hit offset shifts the real tail to hit..L-1
        positions = np.where(base >= 0, base + hit, -1).astype(np.int32)[None]
        self._sync_tables([req])
        step = self._prefill_tail if hit else self._prefill
        tok, self.caches = step(
            self.params, self._in(tokens), self.caches,
            self._in(positions), self._tbl,
            self._in(np.asarray([req.slot], np.int32)))
        self._poll_jit("prefill_tail" if hit else "prefill", (1, Lb))

        req.n_cached = L
        self.n_prefill_tokens += n
        self.n_prefix_hit_tokens += hit
        m = self.metrics
        m.counter("prefill_tokens_total",
                  "tokens pushed through prefill").inc(n)
        m.counter("prefix_hit_tokens_total",
                  "prompt/resume tokens served from cached pages").inc(hit)
        self._observe_packing(n, Lb)
        self.kv.register_upto(req.rid, prefix, L)   # index newly-full pages
        # the prefill's one device->host sync: its first token
        req.tokens.append(int(tok[0]))  # repro: ignore[host-sync-in-hot-path]
        if req.t_first is None:
            req.t_first = self.clock()

    def _decode_batch(self, batch: List[Request]) -> None:
        """One decode step over the running set, padded to a bucket."""
        n = len(batch)
        nb = self.sv.decode_bucket(n)
        tok = np.zeros((nb, 1), np.int32)
        pos = np.full((nb, 1), -1, np.int32)
        slots = np.zeros((nb,), np.int32)
        for i, req in enumerate(batch):
            tok[i, 0] = req.tokens[-1]      # feed the newest generated token
            pos[i, 0] = req.n_cached        # ... at the next cache position
            slots[i] = req.slot
        # pad rows point at slot 0: their positions are -1, so their writes
        # spill and their (masked) attention output is discarded
        self._sync_tables(batch)
        nxt, self.caches = self._decode(
            self.params, self._in(tok), self.caches, self._in(pos),
            self._tbl, self._in(slots))
        self._poll_jit("decode", (nb, 1))
        self._observe_packing(n, nb)
        self.metrics.counter("decode_tokens_total",
                             "tokens emitted by decode steps").inc(n)
        # the step's one sanctioned device->host sync: token readback
        nxt = np.asarray(nxt.cpu())  # repro: ignore[host-sync-in-hot-path]
        ps = self.sv.page_size
        for i, req in enumerate(batch):
            req.n_cached += 1
            req.tokens.append(int(nxt[i]))
            if req.n_cached % ps == 0:
                # a generated-token page just filled: index it
                self.kv.register_upto(req.rid, req.prefix, req.n_cached)
        self.n_decode_tokens += n

    # ------------------------------------------------------------- stats --
    def stats(self) -> Dict:
        retired = [r for r in self._all.values() if r.t_finish is not None]
        done = [r for r in retired if r.outcome == OK]
        outcomes: Dict[str, int] = {}
        for r in retired:
            out = r.outcome or ERROR
            outcomes[out] = outcomes.get(out, 0) + 1
        lat = [r.t_finish - r.t_visible for r in done]
        ttft = [r.t_first - r.t_visible for r in done
                if r.t_first is not None]
        wall = (self.clock() - self.t_start) \
            if self.t_start is not None else 0.0
        pct = (lambda xs, q: float(np.percentile(xs, q)) if xs else None)
        mean = (lambda xs: float(np.mean(xs)) if xs else None)
        demand = self.n_prefill_tokens + self.n_prefix_hit_tokens
        capacity = self.n_tokens_packed + self.n_tokens_wasted
        return {
            "layout": self.sv.layout,
            "step_mode": self.sv.step,
            **({"token_budget": self._budget}
               if self._ragged is not None else {}),
            "device": str(self.device),
            "padding_tokens_wasted": self.n_tokens_wasted,
            "token_utilization": (self.n_tokens_packed / capacity
                                  if capacity else None),
            "requests_finished": len(done),
            "requests_retired": len(retired),
            "outcomes": outcomes,
            "requests_preempted": self.scheduler.n_preemptions,
            "steps": self.n_steps,
            "prefill_tokens": self.n_prefill_tokens,
            "tokens_prefilled_saved": self.n_prefix_hit_tokens,
            "prefix_hit_rate": (self.n_prefix_hit_tokens / demand
                                if demand else 0.0),
            "prefix_cache": {
                "enabled": self.sv.prefix_cache,
                "lookups": self.kv.n_lookups,
                "hit_tokens": self.kv.n_hit_tokens,
                "evictions": self.kv.n_evictions,
            },
            "decode_tokens": self.n_decode_tokens,
            "wall_s": wall,
            "decode_tok_per_s": self.n_decode_tokens / wall if wall else None,
            "latency_p50_s": pct(lat, 50),
            "latency_p95_s": pct(lat, 95),
            "latency_mean_s": mean(lat),
            "ttft_p50_s": pct(ttft, 50),
            "ttft_p95_s": pct(ttft, 95),
            "ttft_mean_s": mean(ttft),
            "kv_pages_high_water": self.kv.high_water,
            "paged_attn": self.rt.paged_attn,
            "recompiles": self.tm.jit_watch.snapshot(),
            "metrics": self.metrics.snapshot(),
        }
