"""Request scheduler: admission queue, continuous batching, preemption and
the ragged step's token planner (a copy of ``repro/serving/scheduler.py``'s
policies; host-side Python only).

Requests join the running set at decode-step boundaries (admission triggers
a prefill), leave it the step they finish, and are preempted back to the
front of the queue when the page pool runs dry.  Preemption is
recompute-style: the victim's pages are released and on re-admission the
prefix (prompt + tokens generated so far) is re-prefilled; with the prefix
cache on, the victim's full pages usually survive in the warm pool and only
the uncached tail is recomputed.

Determinism: slots are assigned lowest-free-first, the decode batch is the
running set in slot order, and the preemption victim is always the
latest-admitted request, so a trace replayed against this port and the JAX
package makes identical scheduling decisions.  Cancellation and deadlines
wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..observability.metrics import NULL_REGISTRY

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"

# terminal request outcomes: every retired request carries exactly one
OK, CANCELLED, TIMEOUT, SHED, ERROR = \
    "ok", "cancelled", "timeout", "shed", "error"
OUTCOMES = (OK, CANCELLED, TIMEOUT, SHED, ERROR)


class ShedError(RuntimeError):
    """The bounded admission queue (``ServingConfig.max_queue``) is full;
    the request was never queued."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # int32 [L]
    max_new: int
    arrival: float = 0.0                # engine-clock time the request exists
    eos_id: Optional[int] = None
    # -- runtime state ----------------------------------------------------
    state: str = WAITING
    outcome: Optional[str] = None       # one of OUTCOMES once retired
    slot: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)  # generated
    n_cached: int = 0                   # tokens written to the KV cache
    decoding: bool = False              # emitted since (re-)admission: the
                                        # ragged planner feeds exactly one
                                        # token a step once this flips
    n_preempts: int = 0
    admit_seq: int = -1                 # admission order (preemption victim key)
    t_visible: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_finish: Optional[float] = None

    @property
    def prefix(self) -> np.ndarray:
        """Prompt + generated-so-far: what a (re-)prefill must process."""
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    @property
    def target_len(self) -> int:
        return len(self.prompt) + self.max_new

    @property
    def done(self) -> bool:
        if len(self.tokens) >= self.max_new:
            return True
        return bool(self.tokens) and self.tokens[-1] == self.eos_id


class Scheduler:
    """Owns the waiting queue and the running set; asks the KV manager for
    capacity decisions."""

    def __init__(self, kv_manager, max_batch: int, metrics=None,
                 max_queue: int = 0):
        self.kv = kv_manager
        self.max_batch = max_batch
        self.max_queue = max_queue      # 0 = unbounded
        self.metrics = metrics if metrics is not None else NULL_REGISTRY
        self.waiting: deque = deque()
        self.running: Dict[int, Request] = {}        # rid -> Request
        self._free_slots: List[int] = list(range(max_batch))
        heapq.heapify(self._free_slots)
        self._admit_counter = 0
        self.n_preemptions = 0

    def submit(self, req: Request) -> None:
        if not self.kv.fits_alone(req.target_len):
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds serving capacity "
                f"({self.kv.capacity_desc()})")
        if self.max_queue and len(self.waiting) >= self.max_queue:
            raise ShedError(
                f"request {req.rid}: admission queue full "
                f"({self.max_queue} waiting) — shedding")
        self.waiting.append(req)

    def admit(self, now: float) -> List[Request]:
        """Admit queue-head requests that have arrived and fit (a free batch
        slot + pages for the prefix and the first decode write).  FIFO: a
        capacity-blocked head blocks later arrivals.  With the prefix cache
        on, the request starts at ``n_cached = hit`` over shared pages."""
        admitted = []
        for req in list(self.waiting):
            if not self._free_slots:
                break
            if req.arrival > now:
                continue
            prefix = req.prefix
            hit = self.kv.admit_request(req.rid, prefix, len(prefix) + 1)
            if hit is None:
                break
            self.waiting.remove(req)
            req.n_cached = hit
            req.decoding = False
            req.slot = heapq.heappop(self._free_slots)
            req.state = RUNNING
            req.t_admit = now
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self.running[req.rid] = req
            admitted.append(req)
            self.metrics.counter("sched_admissions_total",
                                 "requests admitted to the running set").inc()
            if req.n_preempts:
                self.metrics.counter(
                    "sched_resumes_total",
                    "admissions of previously-preempted requests").inc()
        return admitted

    def _evict_running(self, req: Request) -> None:
        self.kv.release(req.rid)
        heapq.heappush(self._free_slots, req.slot)
        del self.running[req.rid]
        req.slot = -1

    def _preempt(self, victim: Request) -> None:
        self._evict_running(victim)
        victim.state = WAITING
        victim.n_cached = 0
        victim.decoding = False
        victim.n_preempts += 1
        self.n_preemptions += 1
        self.metrics.counter("sched_preemptions_total",
                             "requests evicted on pool exhaustion").inc()
        self.waiting.appendleft(victim)   # resumes before new arrivals

    def ensure_decode(self) -> List[Request]:
        """Guarantee every running request a page for this step's KV write;
        evict latest-admitted requests until the survivors fit.  Returns
        the preempted requests."""
        preempted = []
        for req in sorted(self.running.values(), key=lambda r: r.admit_seq):
            while req.rid in self.running \
                    and not self.kv.ensure(req.rid, req.n_cached + 1):
                victim = max(self.running.values(), key=lambda r: r.admit_seq)
                if victim is req and len(self.running) == 1:
                    raise RuntimeError(
                        f"request {req.rid} cannot fit alone "
                        f"(n_cached={req.n_cached}); pool too small")
                self._preempt(victim)
                preempted.append(victim)
        return preempted

    def finish(self, req: Request, now: float) -> None:
        self._evict_running(req)
        req.state = FINISHED
        req.outcome = OK
        req.t_finish = now

    def batch(self) -> List[Request]:
        """The decode batch: running requests in slot order."""
        return sorted(self.running.values(), key=lambda r: r.slot)

    def plan_tokens(self, budget: int) -> List:
        """Token-budget plan for one ragged step: ``[(req, start, n)]``,
        where the step feeds ``req.prefix[start:start + n]`` at positions
        ``start .. start + n - 1``.  Decode tokens come first, one per
        request that has emitted since admission, in slot order; then
        prefill-phase requests chunk their remaining prefix into the budget
        left, first admitted first served.  A prefill that gets no budget
        waits for the next step."""
        plan, used = [], 0
        for req in self.batch():
            if req.decoding and used < budget:
                plan.append((req, req.n_cached, 1))
                used += 1
        for req in sorted((r for r in self.running.values()
                           if not r.decoding), key=lambda r: r.admit_seq):
            if used >= budget:
                break
            n = min(len(req.prefix) - req.n_cached, budget - used)
            if n > 0:
                plan.append((req, req.n_cached, n))
                used += n
        return plan

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running

    def check_invariants(self) -> None:
        """Running slots and the free heap partition [0, max_batch);
        waiting and running are disjoint; every running request's cached
        tokens are covered by its pages; waiting requests hold none."""
        slots = [r.slot for r in self.running.values()]
        assert len(set(slots)) == len(slots), f"duplicate slots {slots}"
        free = set(self._free_slots)
        assert len(free) == len(self._free_slots), "duplicate free slots"
        assert free | set(slots) == set(range(self.max_batch)), \
            f"slot partition broken: free={free} running={slots}"
        w_rids = [r.rid for r in self.waiting]
        assert len(set(w_rids)) == len(w_rids), "rid queued twice"
        assert not set(w_rids) & set(self.running), \
            "rid both waiting and running"
        pages = self.kv.pages
        for req in self.waiting:
            assert req.state == WAITING, (req.rid, req.state)
            assert req.rid not in pages, \
                f"waiting rid {req.rid} still holds pages"
        for req in self.running.values():
            assert req.state == RUNNING, (req.rid, req.state)
            assert (self.kv.pages_for(req.n_cached)
                    <= len(pages.get(req.rid, []))), \
                f"rid {req.rid} cached {req.n_cached} tokens beyond its " \
                f"{len(pages.get(req.rid, []))}-page allocation"
