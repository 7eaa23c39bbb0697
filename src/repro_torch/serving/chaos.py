"""Deterministic fault-injection harness for the serving engine (PyTorch
port of ``repro/serving/chaos.py``).

The harness replays one seeded synthetic trace through an engine while a
seeded event stream injects every lifecycle hazard the stack claims to
survive:

  * **cancel storms**   -- random live requests (queued, prefilling, or
                           mid-decode) cancelled at step boundaries
  * **deadline storms** -- a fraction of requests carry tight TTLs and are
                           retired by the step-boundary sweep
  * **allocator failures** -- ``PagedKVCacheManager.fail_next_admits``
                           makes admissions report capacity failure,
                           exercising the all-or-nothing admission path
  * **step exceptions** -- ``engine.inject_step_fault`` raises at the top
                           of a step; the harness drives steps through
                           ``distributed.fault_tolerance.run_with_retries``
  * **stop/resume**     -- ``engine.snapshot()`` +
                           ``InferenceEngine.restore()`` mid-run; the
                           restored engine continues the same trace

Everything is derived from ``ChaosConfig.seed`` through
``np.random.default_rng`` and a fake step-index clock, so a failing seed
replays exactly, and the same seed makes the same decisions in this port
and in the JAX package.  After every event the harness asserts the
scheduler and page-pool invariants (``check_invariants``); after the run
drains it asserts zero leaked pages and that every surviving request
(outcome ``ok``) emitted the tokens of a fault-free reference run of the
same trace.  Greedy decode over a bf16 (or float32) KV pool is lossless
under recompute-resume and prefix sharing, so cancels, timeouts,
preemptions and restores around a request must not perturb it.

Token identity across the bucketed and ragged step modes (`chaos_report`)
additionally needs both modes to run the same attention arithmetic: on the
CPU with ``Runtime(attn_impl="chunked")`` the plain versions follow the
JAX twins' exact softmax.  On CUDA the ragged step's prefill chunks run
the ragged kernel's online split softmax while bucketed prefill runs the
exact path, so a run on the card holds each mode to a reference of that
mode (`reference_tokens` of the same step mode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..distributed.fault_tolerance import run_with_retries
from .engine import InferenceEngine, build_params
from .scheduler import OK, ShedError


class InjectedFault(RuntimeError):
    """The fault `inject_step_fault` plants: typed, so a test can tell an
    injected failure from a real one escaping the retry wrapper."""


class _StepClock:
    """Fake engine clock: t == current step index.  Deadlines, TTFT and
    the expiry sweep all read it, so a chaos run's timing is a function of
    the seed alone."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Knobs for one seeded chaos run.  Probabilities are per step; every
    draw comes from one ``default_rng([seed, 1])`` stream (the trace uses
    ``[seed, 0]``), so two runs with the same config are identical."""

    seed: int = 0
    n_requests: int = 12
    rate_per_step: float = 1.0
    prompt_lens: Tuple[int, ...] = (6, 12, 20)
    gen_lens: Tuple[int, ...] = (4, 8)
    p_cancel: float = 0.10           # chance of a cancel event this step
    n_cancel: int = 2                # live rids cancelled per event
    p_deadline: float = 0.25         # chance a request carries a TTL
    deadline_range: Tuple[float, float] = (4.0, 40.0)   # steps (fake clock)
    p_alloc_fail: float = 0.08       # arm one injected admission failure
    p_step_fault: float = 0.08       # plant one step exception (retried)
    stop_resume_at: Tuple[int, ...] = ()   # snapshot/restore at these steps
    max_steps: int = 2000


def _make_trace(chaos: ChaosConfig, vocab: int) -> List[Tuple]:
    """(arrival_step, prompt, max_new) triples from the trace stream,
    shared verbatim by the reference and every chaos run."""
    rng = np.random.default_rng([chaos.seed, 0])
    t, out = 0.0, []
    for _ in range(chaos.n_requests):
        t += rng.exponential(1.0 / max(chaos.rate_per_step, 1e-9))
        L = int(rng.choice(list(chaos.prompt_lens)))
        out.append((int(t),
                    rng.integers(0, vocab, size=L, dtype=np.int32),
                    int(rng.choice(list(chaos.gen_lens)))))
    return out


def reference_tokens(cfg, rt, sv, trace: List[Tuple], params=None,
                     device="cuda") -> Dict[int, List[int]]:
    """Fault-free run of the trace: no deadlines, no shedding (max_queue
    lifted), no injected failures.  Returns {rid: generated tokens}, the
    oracle every chaos survivor is compared against."""
    sv = dataclasses.replace(sv, max_queue=0)
    clock = _StepClock()
    eng = InferenceEngine(cfg, rt, sv, params=params, clock=clock,
                          device=device)
    eng.warmup(prompt_lens=[len(p) for _, p, _ in trace])
    out: Dict[int, List[int]] = {}
    i, step_idx = 0, 0
    while i < len(trace) or not eng.scheduler.idle:
        assert step_idx < 100_000, "reference run did not drain"
        clock.t = float(step_idx)
        while i < len(trace) and trace[i][0] <= step_idx:
            eng.submit(trace[i][1], trace[i][2])
            i += 1
        eng.step()
        for r in eng.collect():
            out[r.rid] = list(r.tokens)
        step_idx += 1
    return out


def run_chaos(cfg, rt, sv, chaos: ChaosConfig, params=None,
              reference: Optional[Dict[int, List[int]]] = None,
              device="cuda") -> Dict:
    """One seeded chaos run.  Asserts scheduler + pool invariants after
    every step and restore, a fully drained engine (no leaked pages, every
    submitted request retired with an outcome), and survivor token identity
    against `reference` (computed here, in the same step mode, if not
    given).  Returns a JSON-able report; a failed assertion is the run
    failing."""
    if params is None:
        params = build_params(cfg, rt, device=device)
    trace = _make_trace(chaos, cfg.vocab)
    if reference is None:
        reference = reference_tokens(cfg, rt, sv, trace, params=params,
                                     device=device)

    clock = _StepClock()
    eng = InferenceEngine(cfg, rt, sv, params=params, clock=clock,
                          device=device)
    eng.warmup(prompt_lens=[len(p) for _, p, _ in trace])
    rng = np.random.default_rng([chaos.seed, 1])
    stop_at = set(chaos.stop_resume_at)
    events = {"cancels": 0, "sheds": 0, "alloc_fails": 0,
              "step_faults": 0, "stop_resumes": 0, "deadlines": 0}
    finished: Dict[int, object] = {}

    def check(engine):
        engine.scheduler.check_invariants()
        engine.kv.check_invariants()

    i, step_idx = 0, 0
    while i < len(trace) or not eng.scheduler.idle:
        assert step_idx < chaos.max_steps, \
            f"chaos run (seed {chaos.seed}) not drained " \
            f"after {chaos.max_steps} steps"
        clock.t = float(step_idx)
        while i < len(trace) and trace[i][0] <= step_idx:
            ttl = None
            if rng.random() < chaos.p_deadline:
                ttl = float(rng.uniform(*chaos.deadline_range))
                events["deadlines"] += 1
            try:
                eng.submit(trace[i][1], trace[i][2], deadline_s=ttl)
            except ShedError:
                events["sheds"] += 1      # still retires through collect()
            i += 1
        if rng.random() < chaos.p_cancel:
            live = sorted(rid for rid, r in eng._all.items()
                          if r.t_finish is None)
            for j in rng.permutation(len(live))[:chaos.n_cancel]:
                if eng.cancel(live[int(j)]):
                    events["cancels"] += 1
                check(eng)
        if rng.random() < chaos.p_alloc_fail:
            eng.kv.fail_next_admits += 1
            events["alloc_fails"] += 1
        if rng.random() < chaos.p_step_fault:
            eng.inject_step_fault(
                InjectedFault(f"injected at step {step_idx}"))
            events["step_faults"] += 1
        run_with_retries(eng.step, max_retries=2)
        for r in eng.collect():
            finished[r.rid] = r
        check(eng)
        if step_idx in stop_at:
            snap = eng.snapshot()
            eng = InferenceEngine.restore(snap, params=params, clock=clock)
            events["stop_resumes"] += 1
            check(eng)
        step_idx += 1

    # -- drain assertions --------------------------------------------------
    check(eng)
    leaked = eng.kv.in_use
    assert leaked == 0, f"{leaked} pages leaked after drain"
    assert sorted(finished) == list(range(chaos.n_requests)), \
        f"requests lost: retired {sorted(finished)}"
    outcomes: Dict[str, int] = {}
    for r in finished.values():
        assert r.outcome is not None, f"rid {r.rid} retired without outcome"
        outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1

    # -- survivor token identity ------------------------------------------
    survivors = {rid: r for rid, r in finished.items() if r.outcome == OK}
    mismatched = [rid for rid, r in survivors.items()
                  if list(r.tokens) != reference[rid]]
    assert not mismatched, \
        f"seed {chaos.seed}: survivors {mismatched} diverged from the " \
        f"fault-free reference"
    return {
        "seed": chaos.seed,
        "step_mode": sv.step,
        "steps": step_idx,
        "events": events,
        "outcomes": outcomes,
        "survivors": len(survivors),
        "survivors_identical": True,
        "leaked_pages": leaked,
        "preemptions": eng.scheduler.n_preemptions,
        "recompiles_steady_state": eng.tm.jit_watch.steady_state,
        "pool_high_water": eng.kv.high_water,
    }


#: cancel-heavy preset: every hazard off but a high-rate cancel storm, the
#: scenario that stresses refcount bookkeeping hardest (shared prefix pages
#: must stay warm while their siblings die mid-decode)
CANCEL_STORM = ChaosConfig(p_cancel=0.5, n_cancel=3, p_deadline=0.0,
                           p_alloc_fail=0.0, p_step_fault=0.0)


def chaos_report(cfg, rt, sv, chaos: ChaosConfig,
                 modes: Tuple[str, ...] = ("bucketed", "ragged"),
                 params=None, device="cuda") -> Dict:
    """Run the same seeded chaos scenario in every requested step mode
    against one fault-free bucketed reference (cross-mode identity needs
    the same attention arithmetic in both modes: ``rt.attn_impl ==
    "chunked"`` on the CPU).  Aggregates the per-run reports under top-level
    pass/fail fields."""
    if params is None:
        params = build_params(cfg, rt, device=device)
    trace = _make_trace(chaos, cfg.vocab)
    ref = reference_tokens(cfg, rt,
                           dataclasses.replace(sv, step="bucketed"),
                           trace, params=params, device=device)
    runs = [run_chaos(cfg, rt, dataclasses.replace(sv, step=mode),
                      chaos, params=params, reference=ref, device=device)
            for mode in modes]
    return {
        "seed": chaos.seed,
        "survivors_identical": all(r["survivors_identical"] for r in runs),
        "recompiles_steady_state": max(r["recompiles_steady_state"]
                                       for r in runs),
        "leaked_pages": max(r["leaked_pages"] for r in runs),
        "runs": runs,
    }
