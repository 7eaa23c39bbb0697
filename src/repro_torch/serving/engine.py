"""Inference engine: runs the serving steps over the scheduled batch with
per-request state tracking and latency/throughput stats (PyTorch port of
``repro/serving/engine.py``: both KV layouts, both step modes).

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

The contiguous layout (``sv.layout == "contiguous"``, bucketed steps only)
gives each batch slot a max_ctx cache row (``models.transformer.
init_caches``); stacks with Mamba blocks serve only through it, their
prompts prefilled at exact length (an SSM state integrates pad tokens, so
every prompt length is its own step shape).  Its prefill runs on a fresh
row and scatters it into the request's slot, its decode gathers the
batch's rows, steps and scatters them back, both inside the step
(``launch.steps.make_serving_steps(paged=False)``); a decode batch's
padding rows name free slots, distinct from the batch's, and write back
what they read.

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

Lifecycle (host-side, outside the captured steps): `cancel` retires a
queued or running request, a deadline given at `submit` retires it with
outcome timeout at the first step boundary past it, a full bounded queue
sheds, `inject_step_fault` raises at the top of the next step before any
mutation (so ``distributed.fault_tolerance.run_with_retries`` retries
against unchanged state), and an optional watchdog
(``ServingConfig.step_deadline_s``) counts overrunning steps, or raises
when strict.  `snapshot` / `restore` stop and resume the engine at a step
boundary: the restored engine copies the pools and the table pool into its
own tensors, which stay the storage its captured graphs read.  `profile`
attributes one decode step's time to the decode attention kernel and the
rest.  The telemetry bundle adds a trace recorder (off by default): one
Perfetto lane per batch slot with each request's residency and its
prefills, and an engine lane with one span per step.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.quant_plan import SERVE_PACKED, LayerPacker, active_plan
from ..distributed.fault_tolerance import StepDeadlineExceeded, Watchdog
from ..kernels import autotune
from ..launch.steps import (CapturedStep, cuda_graph_capture,
                            make_ragged_step, make_serving_steps)
from ..models.transformer import init_caches, init_model, with_layer_views
from ..observability import Telemetry
from ..observability.metrics import COUNT_BUCKETS, MetricsRegistry
from .kv_pages import (ContinuousKVCache, PagedKVCacheManager,
                       init_paged_caches)
from .scheduler import (CANCELLED, ERROR, OK, SHED, TIMEOUT, Request,
                        Scheduler, ShedError)


#: the step functions, as the engine's attributes (``_<name>``) and the
#: recompile sentinel's function names
STEP_NAMES = ("prefill", "prefill_tail", "decode", "ragged")


class EngineStuckError(RuntimeError):
    """run_until_idle() exhausted its step budget with work still queued
    or running.  Carries the stuck state: the rids queued and running and
    the pool's pages in use."""

    def __init__(self, max_steps: int, queued, running,
                 pool_in_use: int, pool_pages: int):
        self.max_steps = max_steps
        self.queued = list(queued)
        self.running = list(running)
        self.pool_in_use = pool_in_use
        self.pool_pages = pool_pages
        super().__init__(
            f"engine not idle after {max_steps} steps: "
            f"queued rids {self.queued}, running rids {self.running}, "
            f"pool {pool_in_use}/{pool_pages} pages in use")


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
    f32 master, which the on-the-fly backends quantize per call.

    The build goes a layer at a time (``quant_plan.LayerPacker``): each
    block is packed as soon as it is drawn, an expert stack one expert at a
    time, so the build holds the packed model beside one block's f32
    masters.  It equals ``pack_for_serving(init_model(gen, cfg), cfg, rt)``
    bit for bit."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    plan = active_plan(cfg, rt)
    packer = LayerPacker(cfg, plan) if plan.backends & SERVE_PACKED else None
    return init_model(gen, cfg, packer)


def _pool_leaves(caches: Dict) -> List[tuple]:
    """(path, tensor) of every pool leaf of `caches` in a fixed order: the
    K/V pools and their scales, not the per-step routing leaves ("tbl",
    "slots") a step binds."""
    out: List[tuple] = []

    def walk(node, path):
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                walk(val, path + (key,))
            elif key not in ("tbl", "slots"):
                out.append((path + (key,), val))

    walk(caches, ())
    return out


class InferenceEngine:
    """submit() requests, step() the world, collect() finished requests."""

    def __init__(self, cfg, rt, sv, params=None, seed: int = 0,
                 clock=time.time, metrics: Optional[MetricsRegistry] = None,
                 device="cuda", telemetry: Optional[Telemetry] = None):
        # an SSM state integrates every input token, so left-padded prefill
        # would pollute it: stacks with other blocks than attention serve
        # through the contiguous layout with exact-length prefill
        blocks = tuple(cfg.pattern) + tuple(cfg.tail)
        self._all_attention = all(bt == "A" for bt in blocks)
        if not (self._all_attention or sv.layout == "contiguous"):
            raise ValueError(
                f"paged KV serving requires an all-attention arch (got "
                f"{blocks}); use layout='contiguous'")
        self.cfg, self.rt, self.sv = cfg, rt, sv
        self.device = resolve_device(device)
        self.clock = clock
        # metrics registry + recompile sentinel (`metrics` alone keeps the
        # sentinel counting into that registry)
        self.tm = telemetry if telemetry is not None \
            else Telemetry(registry=metrics)
        self.metrics = self.tm.registry
        self.trace = self.tm.trace
        self.trace.lane(0, "engine")
        for slot in range(sv.max_batch):
            self.trace.lane(1 + slot, f"slot{slot}")
        # rid -> (trace t0, slot): the open residency segment of a request,
        # one span on its slot's lane when it retires or is preempted
        self._seg: Dict[int, tuple] = {}
        if params is None:
            params = build_params(cfg, rt, seed, self.device)
        self.params = with_layer_views(params, cfg)

        self._paged = sv.layout == "paged"
        if self._paged:
            self.kv = PagedKVCacheManager(sv, metrics=self.metrics)
            self.caches = init_paged_caches(cfg, rt, sv, device=self.device)
            # rows start at the sentinel (== num_pages): writes through an
            # unassigned slot go to the spill page, reads are zeros.
            # Updated in place (`_sync_tables`): one tensor for the engine's
            # lifetime, which the captured steps read where it lies
            self._tbl = torch.full((sv.max_batch, sv.pages_per_seq),
                                   sv.num_pages, dtype=torch.int32,
                                   device=self.device)
        else:
            self.kv = ContinuousKVCache(sv, metrics=self.metrics)
            self.caches = init_caches(cfg, rt, batch=sv.max_batch,
                                      seq=sv.max_ctx, device=self.device)
            self._tbl = None
        # rid -> (slot, uploaded page ids): a row re-uploads only when the
        # allocation changed
        self._tbl_ver: Dict[int, tuple] = {}
        self.scheduler = Scheduler(self.kv, sv.max_batch,
                                   metrics=self.metrics,
                                   max_queue=sv.max_queue)
        # tuned plans for the GEMM kernels: every CUDA wrapper looks its
        # shape up in kernels.autotune's cache when it cuts a launch (and
        # when a step is captured), so loading the cache before the first
        # step is all the wiring needed; no cache file, the rules' plans
        autotune.ensure_loaded()
        self._prefill, self._prefill_tail, self._decode = make_serving_steps(
            cfg, rt, paged=self._paged, max_ctx=sv.max_ctx)
        # ragged token-major step: one step function whose shape is the
        # padded token budget, whatever the batch's mix of prefill chunks
        # and decode tokens
        self._ragged = make_ragged_step(cfg, rt) \
            if sv.step == "ragged" else None
        self._budget = sv.budget
        # step watchdog (ServingConfig.step_deadline_s): an overrunning step
        # is counted, and raises in strict mode
        self._watchdog = (Watchdog(sv.step_deadline_s)
                          if sv.step_deadline_s > 0 else None)
        # chaos hook: raised at the top of the next step(), before any
        # state changes
        self._inject_fault: Optional[Exception] = None
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
        self._last_packed = 0
        self._last_wasted = 0
        self.t_start = None
        self._profile: Optional[Dict] = None
        self._profile_step: Optional[int] = None

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
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request.  ``deadline_s`` is a time to live from now: the
        step-boundary sweep retires the request with outcome timeout once
        it passes, queued or mid-decode.  Raises ShedError when the bounded
        admission queue is full and ValueError when the request can never
        fit; both retire it (outcome shed / error), collectable via
        collect()."""
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new=max_new,
                      arrival=now if arrival is None else arrival,
                      eos_id=eos_id,
                      deadline=(now + deadline_s
                                if deadline_s is not None else None))
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

    def cancel(self, rid: int, outcome: str = CANCELLED) -> bool:
        """Cancel a queued, prefilling or decoding request: its pages are
        released (shared prefix pages stay warm), its slot frees at this
        step boundary, and it retires with `outcome`, collectable via
        collect().  False when rid is unknown or already retired."""
        req = self._all.get(rid)
        if req is None or req.t_finish is not None:
            return False
        retired = self.scheduler.cancel(rid, self.clock(), outcome)
        if retired is None:
            return False
        self._finish_aborted(retired)
        return True

    def collect(self) -> List[Request]:
        out, self._finished = self._finished, []
        return out

    def warmup(self, prompt_lens=()) -> None:
        """Run every expected step shape once (one prefill per prompt
        bucket, one decode per batch bucket) before the measured window,
        so first-call costs (kernel loading, allocator growth and, on CUDA,
        the shape's capture) stay out of the stats.  Every position is -1:
        all writes go to the spill page and the pool is untouched (the
        contiguous steps write back every row they read).  The ragged step
        has one shape, the token budget, so it warms with one call whatever
        the prompts; an SSM stack's prompts warm at their exact lengths."""
        if self._ragged is not None:
            self._warm_ragged()
            return
        slot0 = torch.zeros((1,), dtype=torch.int32, device=self.device)
        for L in sorted({self._prompt_pad(n) for n in prompt_lens}):
            tokens = torch.zeros((1, L), dtype=torch.int32, device=self.device)
            positions = torch.full((1, L), -1, dtype=torch.int32,
                                   device=self.device)
            _, self.caches = self._prefill(self.params, tokens, self.caches,
                                           positions, self._tbl, slot0)
            self._poll_jit("prefill", (1, L))
            if self._paged and self.sv.prefix_cache:
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
            # nb distinct rows (the contiguous step writes each back as it
            # read it)
            slots = torch.arange(nb, dtype=torch.int32, device=self.device)
            _, self.caches = self._decode(self.params, tok, self.caches, pos,
                                          self._tbl, slots)
            self._poll_jit("decode", (nb, 1))

    def inject_step_fault(self, exc: Exception) -> None:
        """Chaos hook: raise `exc` at the top of the next step(), before
        any scheduler or pool change, so wrapping step() in
        ``run_with_retries`` retries against unchanged state."""
        self._inject_fault = exc

    def step(self) -> int:
        """One decode-step boundary; returns the number of running requests
        after the step (0 = idle).  An injected fault fires first, then the
        deadline sweep retires overdue requests (before admission can spend
        pages on them); the watchdog, when set, watches the rest."""
        if self._inject_fault is not None:
            exc, self._inject_fault = self._inject_fault, None
            raise exc
        for req in self.scheduler.expire(self.clock()):
            self._finish_aborted(req)
        wd = self._watchdog
        if wd is not None:
            wd.arm()
        try:
            n = (self._step_ragged() if self._ragged is not None
                 else self._step_bucketed())
        finally:
            if wd is not None:
                wd.disarm()
        if wd is not None and wd.fired.is_set():
            self.metrics.counter(
                "serving_step_deadline_exceeded_total",
                "engine steps that overran the watchdog deadline").inc()
            if self.sv.step_deadline_strict:
                raise StepDeadlineExceeded(
                    f"serving step {self.n_steps - 1} exceeded "
                    f"{self.sv.step_deadline_s:.3f}s deadline")
        return n

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
        tt0 = self.trace.now()
        now = self.clock()
        if self.t_start is None:
            self.t_start = now
        admitted = self.scheduler.admit(now)
        n_tail = sum(1 for r in admitted if r.n_cached)
        for req in admitted:
            self._prefill_request(req)
        self._retire()                 # a 1-token request is done at prefill
        self._close_preempted(self.scheduler.ensure_decode())
        batch = self.scheduler.batch()
        if batch:
            self._decode_batch(batch)
        self.n_steps += 1
        self._retire()
        self._observe_step(t0, tt0, admitted, n_tail, batch)
        return len(self.scheduler.running)

    def _close_preempted(self, preempted: List[Request]) -> None:
        """A preemption ends a request's slot residency: close its segment
        so the timeline shows the slot going dark."""
        for req in preempted:
            seg = self._seg.pop(req.rid, None)
            if seg is not None:
                self.trace.complete(f"r{req.rid}", 1 + seg[1], seg[0],
                                    rid=req.rid, outcome="preempted",
                                    gen=len(req.tokens))

    def _step_ragged(self) -> int:
        """One ragged token-major step: admit, plan a token budget's worth
        of work, run one step over the flat pack, apply its emissions.  An
        admitted request's prefix drains through the planner as chunks,
        possibly over several steps, beside everyone else's decode
        tokens."""
        t0 = time.perf_counter()
        tt0 = self.trace.now()
        now = self.clock()
        if self.t_start is None:
            self.t_start = now
        admitted = self.scheduler.admit(now)
        n_tail = sum(1 for r in admitted if r.n_cached)
        for req in admitted:
            # prefix-cache hits are realized at admission: the planner only
            # ever feeds prefix[n_cached:]
            hit = req.n_cached
            self.n_prefix_hit_tokens += hit
            self.metrics.counter(
                "prefix_hit_tokens_total",
                "prompt/resume tokens served from cached pages").inc(hit)
            self._seg.setdefault(req.rid, (self.trace.now(), req.slot))
        self._close_preempted(self.scheduler.ensure_decode())
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
        self._observe_step(t0, tt0, admitted, n_tail,
                           [r for r, _, _ in plan if r.decoding])
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
        tp0 = self.trace.now()
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
                if self.trace.enabled:
                    self.trace.complete("chunk_prefill", 1 + req.slot, tp0,
                                        rid=req.rid, tokens=n, start=start)
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

    def _observe_step(self, t0: float, tt0: float, admitted: List[Request],
                      n_tail: int, batch: List[Request]) -> None:
        """Per-step telemetry: wall time and batch size into the registry,
        occupancy gauges at the step boundary, the step's token
        utilization, and the engine lane's step span."""
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
        # useful rows over useful + padding rows computed since the last
        # boundary
        du = self.n_tokens_packed - self._last_packed
        dw = self.n_tokens_wasted - self._last_wasted
        self._last_packed = self.n_tokens_packed
        self._last_wasted = self.n_tokens_wasted
        if du + dw:
            m.gauge("token_utilization",
                    "useful fraction of the step's padded token capacity"
                    ).set(du / (du + dw))
        if self._paged:
            m.gauge("kv_pool_in_use_pages",
                    "pages held by running requests").set(self.kv.in_use)
            m.gauge("kv_pool_warm_pages",
                    "refcount-0 pages still indexed").set(len(self.kv.warm))
            m.gauge("kv_pool_blank_pages",
                    "free pages with no content").set(len(self.kv.blank))
            m.gauge("kv_pool_occupancy",
                    "in-use fraction of the page pool").set(
                        self.kv.in_use / self.sv.num_pages)
            m.gauge("kv_pool_high_water_pages",
                    "peak concurrent in-use pages").set(self.kv.high_water)
        if self.trace.enabled:
            self.trace.complete(
                "step", 0, tt0,
                decode_rows=len(batch),
                prefills=len(admitted) - n_tail, tail_prefills=n_tail,
                queue_depth=len(self.scheduler.waiting),
                pool_in_use=getattr(self.kv, "in_use", 0))

    def _retire(self) -> None:
        now = self.clock()
        for req in list(self.scheduler.running.values()):
            if req.done:
                self.scheduler.finish(req, now)
                self._finished.append(req)
                self._observe_retire(req)

    def _finish_aborted(self, req: Request) -> None:
        """Land a request the scheduler aborted (cancel, deadline) in the
        collect() queue with its retirement telemetry."""
        self._finished.append(req)
        self._observe_retire(req)

    def _observe_retire(self, req: Request) -> None:
        """Retirement telemetry, recorded when t_finish is stamped: the
        retire counter and latency histograms carry the request's outcome
        (ok, cancelled, timeout, shed, error); requests_finished_total
        counts ok alone; the residency segment closes on the slot's
        lane."""
        m = self.metrics
        out = req.outcome or ERROR
        m.counter("requests_retired_total", "requests retired, any outcome",
                  outcome=out).inc()
        if out == OK:
            m.counter("requests_finished_total",
                      "requests fully decoded").inc()
        elif out == CANCELLED:
            m.counter("serving_cancelled_total",
                      "requests cancelled before finishing").inc()
        elif out == TIMEOUT:
            m.counter("serving_timeout_total",
                      "requests retired past their deadline").inc()
        elif out == SHED:
            m.counter("serving_shed_total",
                      "requests shed by the bounded admission queue").inc()
        m.histogram("request_latency_us", "submit-to-retire wall time",
                    outcome=out).observe((req.t_finish - req.t_visible) * 1e6)
        if req.t_first is not None:
            m.histogram("ttft_us", "time to first token",
                        outcome=out).observe(
                            (req.t_first - req.t_visible) * 1e6)
            if len(req.tokens) > 1:
                m.histogram("itl_us",
                            "mean inter-token latency per request",
                            outcome=out).observe(
                                (req.t_finish - req.t_first) * 1e6
                                / (len(req.tokens) - 1))
        seg = self._seg.pop(req.rid, None)
        if seg is not None:
            self.trace.complete(f"r{req.rid}", 1 + seg[1], seg[0],
                                rid=req.rid, outcome=out,
                                gen=len(req.tokens),
                                preempts=req.n_preempts)

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and self.scheduler.idle:
                return
        self.metrics.counter(
            "serving_engine_stuck_total",
            "run_until_idle step-budget exhaustions").inc()
        raise EngineStuckError(
            max_steps, [r.rid for r in self.scheduler.waiting],
            list(self.scheduler.running), getattr(self.kv, "in_use", 0),
            self.sv.num_pages if self._paged else 0)

    # -------------------------------------------------------- internals --
    def _poll_jit(self, name: str, shape) -> None:
        """Poll the recompile sentinel right after a step call, attributing
        any new capture to `shape` (the call's bucket signature)."""
        self.tm.jit_watch.after_call(name, shape, step=self.n_steps)

    def _prompt_pad(self, L: int) -> int:
        """Prompt lengths bucket to powers of two for attention stacks; an
        SSM state integrates pad tokens, so other stacks prefill at exact
        length."""
        return self.sv.prompt_bucket(L) if self._all_attention else L

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
        traffic.  The contiguous layout has no tables."""
        if not self._paged:
            return
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
        one, left-padded to a power-of-two bucket; an SSM stack's at exact
        length) and emit its first token.  After a prefix-cache hit
        (``req.n_cached`` > 0, paged only) only the tail runs, through the
        tail-prefill step that attends over the cached pages.  The
        contiguous prefill runs on a fresh row, scattered into the request's
        slot (evicting any earlier tenant's state)."""
        prefix = req.prefix
        L = len(prefix)
        hit = req.n_cached                     # page-aligned, < L by design
        tail = prefix[hit:]
        n = len(tail)
        Lb = self._prompt_pad(n)
        tokens = np.zeros((1, Lb), np.int32)
        tokens[0, Lb - n:] = tail
        base = np.arange(Lb, dtype=np.int32) - (Lb - n)
        # pad rows stay negative (spilled writes, masked queries) after the
        # hit offset shifts the real tail to hit..L-1
        positions = np.where(base >= 0, base + hit, -1).astype(np.int32)[None]
        # open the slot-residency segment (a resume opens a new one) and
        # record this prefill as a span
        self._seg.setdefault(req.rid, (self.trace.now(), req.slot))
        tp0 = self.trace.now()
        self._sync_tables([req])
        step = self._prefill_tail if hit else self._prefill
        tok, self.caches = step(
            self.params, self._in(tokens), self.caches,
            self._in(positions), self._tbl,
            self._in(np.asarray([req.slot], np.int32)))
        self._poll_jit("prefill_tail" if hit else "prefill", (1, Lb))
        self.trace.complete("tail_prefill" if hit else "prefill",
                            1 + req.slot, tp0, rid=req.rid, tokens=n,
                            hit=hit, bucket=Lb)

        req.n_cached = L
        self.n_prefill_tokens += n
        self.n_prefix_hit_tokens += hit
        m = self.metrics
        m.counter("prefill_tokens_total",
                  "tokens pushed through prefill").inc(n)
        if hit:
            m.counter("tail_prefill_tokens_total",
                      "prefill tokens behind a prefix-cache hit").inc(n)
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
        # pad rows name free slots, distinct from the batch's: their
        # positions are -1, so paged writes spill, the contiguous step
        # writes back the row it read (it scatters every row it gathers),
        # and their (masked) attention output is discarded
        used = {r.slot for r in batch}
        slots[n:] = [s for s in range(self.sv.max_batch)
                     if s not in used][:nb - n]
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
            if self._paged and req.n_cached % ps == 0:
                # a generated-token page just filled: index it
                self.kv.register_upto(req.rid, req.prefix, req.n_cached)
        self.n_decode_tokens += n

    # ------------------------------------------------------- stop/resume --
    def snapshot(self) -> Dict:
        """Freeze the engine at a step boundary: every request's progress,
        the scheduler's queues and slots, the page manager's bookkeeping,
        the KV pools and the table pool (copied to host tensors) and the
        counters.  `InferenceEngine.restore(snap)` builds an engine that
        continues as this one would have: the pools are restored verbatim,
        so nothing is recomputed.  Call between steps.  The dict is
        same-process state: configs are held by reference and the prefix
        index keys are Python hashes (stable across processes only with
        ``PYTHONHASHSEED`` pinned)."""
        def _req(req: Request) -> Dict:
            d = {f.name: getattr(req, f.name)
                 for f in dataclasses.fields(Request)}
            d["prompt"] = np.array(d["prompt"], np.int32)
            d["tokens"] = list(d["tokens"])
            return d

        sch = self.scheduler
        return {
            "cfg": self.cfg, "rt": self.rt, "sv": self.sv,
            "device": str(self.device),
            "requests": {rid: _req(r) for rid, r in self._all.items()},
            "finished": [r.rid for r in self._finished],
            "waiting": [r.rid for r in sch.waiting],
            "running": list(sch.running),          # insertion order
            "free_slots": list(sch._free_slots),   # heap layout, verbatim
            "admit_counter": sch._admit_counter,
            "n_preemptions": sch.n_preemptions,
            "kv": self.kv.state(),
            "caches": [t.to("cpu", copy=True)
                       for _, t in _pool_leaves(self.caches)],
            "tbl": (self._tbl.to("cpu", copy=True) if self._paged
                    else None),
            "budget": self._budget if self._ragged is not None else None,
            "next_rid": self._next_rid,
            "counters": {
                "n_steps": self.n_steps,
                "n_decode_tokens": self.n_decode_tokens,
                "n_prefill_tokens": self.n_prefill_tokens,
                "n_prefix_hit_tokens": self.n_prefix_hit_tokens,
                "n_tokens_packed": self.n_tokens_packed,
                "n_tokens_wasted": self.n_tokens_wasted,
                "t_start": self.t_start,
            },
        }

    @classmethod
    def restore(cls, snap: Dict, params=None, seed: int = 0,
                clock=time.time, telemetry: Optional[Telemetry] = None
                ) -> "InferenceEngine":
        """Build an engine on the snapshot's device from a `snapshot()` and
        resume where it stopped.  Weights are not in the snapshot: pass the
        same `params` (or the same `seed`).  The new engine's steps capture
        each shape at its first call (counted as compiles, never as
        steady-state recompiles)."""
        eng = cls(snap["cfg"], snap["rt"], snap["sv"], params=params,
                  seed=seed, clock=clock, telemetry=telemetry,
                  device=snap["device"])
        eng._load_snapshot(snap)
        return eng

    def _load_snapshot(self, snap: Dict) -> None:
        """Load `snap` into this engine.  The pools and the table pool are
        copied into the engine's own tensors, never rebound: they stay the
        storage every graph captured before the load reads and writes."""
        reqs: Dict[int, Request] = {}
        for rid, d in snap["requests"].items():
            d = dict(d)
            d["prompt"] = np.array(d["prompt"], np.int32)
            d["tokens"] = list(d["tokens"])
            reqs[rid] = Request(**d)
        self._all = reqs
        self._finished = [reqs[r] for r in snap["finished"]]
        sch = self.scheduler
        sch.waiting = deque(reqs[r] for r in snap["waiting"])
        sch.running = {r: reqs[r] for r in snap["running"]}
        sch._free_slots = list(snap["free_slots"])
        sch._admit_counter = snap["admit_counter"]
        sch.n_preemptions = snap["n_preemptions"]
        self.kv.load_state(snap["kv"])
        if self._ragged is not None and snap["budget"] is not None:
            # the source engine's (possibly grown) budget, so the plan packs
            # as it would have; a new shape is captured at first use
            self._budget = snap["budget"]
        leaves = _pool_leaves(self.caches)
        if [tuple(t.shape) for _, t in leaves] != \
                [tuple(t.shape) for t in snap["caches"]]:
            raise ValueError("snapshot: the KV pools' shapes differ from "
                             "this engine's")
        for (_, dst), src in zip(leaves, snap["caches"]):
            dst.copy_(src)
        if self._paged:
            self._tbl.copy_(snap["tbl"])
        # empty version map: running requests' rows upload again on their
        # next batch (versions key on slot and page ids)
        self._tbl_ver = {}
        self._next_rid = snap["next_rid"]
        c = snap["counters"]
        self.n_steps = c["n_steps"]
        self.n_decode_tokens = c["n_decode_tokens"]
        self.n_prefill_tokens = c["n_prefill_tokens"]
        self.n_prefix_hit_tokens = c["n_prefix_hit_tokens"]
        self.n_tokens_packed = self._last_packed = c["n_tokens_packed"]
        self.n_tokens_wasted = self._last_wasted = c["n_tokens_wasted"]
        self.t_start = c["t_start"]
        sch.check_invariants()
        self.kv.check_invariants()

    # ----------------------------------------------------------- profile --
    def profile(self, reps: int = 3) -> Dict:
        """Attribute one full-context decode step's time: the whole step
        (the captured one on CUDA; ragged: the step at the token budget,
        all padding) against the decode attention op alone (the same
        ``kernels.ops`` entry the model calls, or for the contiguous layout
        the exact attention over the rows; timed once and counted
        once for each attention block, the hybrid's 12 of 38 included; 0
        for a stack without attention), so a
        regression can be pinned on attention or on the GEMMs and the
        rest.  Best of `reps` timed calls after one
        untimed call.  Call when idle: the probe steps write through stale
        table rows and scratch the pool.  The result lands in
        ``stats()["profile"]``."""
        dev, cfg, sv = self.device, self.cfg, self.sv

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def best_us(fn):
            fn()
            sync()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                sync()
                ts.append((time.perf_counter() - t0) * 1e6)
            return float(min(ts))

        nb = sv.max_batch
        rng = np.random.default_rng(0)
        q = torch.from_numpy(rng.standard_normal(
            (nb, cfg.n_heads, cfg.hd))).to(torch.bfloat16).to(dev)
        last = torch.full((nb,), sv.max_ctx - 1, dtype=torch.int32,
                          device=dev)
        if self._ragged is not None:
            T = self._budget
            rtok = np.zeros((1, T), np.int32)
            rpos = np.full((1, T), -1, np.int32)
            rslots = np.full((T,), -1, np.int32)
            remit = np.full((nb,), -1, np.int32)

            def step():
                nxt, self.caches = self._ragged(
                    self.params, self._in(rtok), self.caches,
                    self._in(rpos), self._tbl, self._in(rslots),
                    self._in(remit))
                return nxt
        else:
            tok = np.zeros((nb, 1), np.int32)
            pos = np.full((nb, 1), sv.max_ctx - 1, np.int32)
            # the JAX engine's probe rows: paged, every row through slot
            # 0's table row; contiguous, the rows 0..nb-1 (both scratched)
            slots = (np.zeros((nb,), np.int32) if self._paged
                     else np.arange(nb, dtype=np.int32))

            def step():
                nxt, self.caches = self._decode(
                    self.params, self._in(tok), self.caches, self._in(pos),
                    self._tbl, self._in(slots))
                return nxt

        step_us = best_us(step)

        from ..kernels import ops
        from ..models.attention import _cache_read, attention_core

        attn = next(({k: v[0] for k, v in blk["attn"].items()
                      if k not in ("tbl", "slots")}
                     for blk in self.caches["rep"].values() if "attn" in blk),
                    None)
        if attn is None:
            # an SSM stack: no attention to attribute, the whole step is
            # GEMMs and the recurrence
            self._profile = {"decode_step_us": round(step_us, 1),
                             "attn_us": 0.0,
                             "gemm_other_us": round(step_us, 1),
                             "attn_frac": 0.0, "at_step": self.n_steps}
            self._profile_step = self.n_steps
            self.tm.jit_watch.absorb()
            return self._profile
        if not self._paged:
            # contiguous: exact attention over the first nb rows' caches,
            # every slot marked valid (a full-window attention whatever
            # state the run left behind)
            rows = {k: v[:nb] for k, v in attn.items() if k != "pos"}
            kpos = torch.arange(rows["kpos"].shape[1], dtype=torch.int32,
                                device=dev).expand_as(rows["kpos"])

            def attn_op():
                kf, vf = _cache_read(rows)
                return attention_core(
                    q[:, None], kf, vf, q_positions=last[:, None],
                    k_positions=kpos, window=cfg.local_window, impl="full",
                    chunk_q=self.rt.attn_chunk_q)
        elif self._ragged is not None:
            T = self._budget
            qT = torch.from_numpy(rng.standard_normal(
                (T, cfg.n_heads, cfg.hd))).to(torch.bfloat16).to(dev)
            tslots = torch.zeros((T,), dtype=torch.int32, device=dev)
            tpos = torch.full((T,), sv.max_ctx - 1, dtype=torch.int32,
                              device=dev)

            def attn_op():
                return ops.ragged_paged_attention(
                    qT, attn["k"], attn["v"], self._tbl, tslots, tpos,
                    attn.get("k_scale"), attn.get("v_scale"),
                    window=cfg.local_window)
        elif self.rt.paged_attn == "fused":
            def attn_op():
                return ops.paged_decode_attention(
                    q, attn["k"], attn["v"], self._tbl[:nb], last,
                    attn.get("k_scale"), attn.get("v_scale"),
                    window=cfg.local_window)
        else:
            from .kv_pages import paged_read

            def attn_op():
                kf, vf, kpos = paged_read(dict(attn, tbl=self._tbl[:nb]),
                                          last)
                return attention_core(
                    q[:, None], kf, vf, q_positions=last[:, None],
                    k_positions=kpos, window=cfg.local_window,
                    impl="full", chunk_q=self.rt.attn_chunk_q)

        with torch.inference_mode():
            n_attn = sum(bt == "A" for bt in cfg.pattern) * cfg.n_repeats \
                + sum(bt == "A" for bt in cfg.tail)
            attn_us = best_us(attn_op) * n_attn
        self._profile = {
            "decode_step_us": round(step_us, 1),
            "attn_us": round(attn_us, 1),
            "gemm_other_us": round(max(step_us - attn_us, 0.0), 1),
            "attn_frac": round(min(attn_us / step_us, 1.0), 4)
            if step_us else None,
            "at_step": self.n_steps,
        }
        self._profile_step = self.n_steps
        # a probe can hit a shape no step has run (a decode bucket the run
        # never filled): re-baseline the sentinel so that capture is not
        # read as the next real step's recompile
        self.tm.jit_watch.absorb()
        return self._profile

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
                "enabled": self._paged and self.sv.prefix_cache,
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
            "paged_attn": self.rt.paged_attn if self._paged else None,
            "recompiles": self.tm.jit_watch.snapshot(),
            "metrics": self.metrics.snapshot(),
            **({"profile": self._profile,
                "profile_at_step": self._profile_step}
               if self._profile else {}),
        }
