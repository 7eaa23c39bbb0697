"""Serving step functions for the continuous-batching engine (PyTorch port
of ``repro/launch/steps.py``: ``make_serving_steps`` and
``make_ragged_step``, paged layout).

Each step gathers the batch's block-table rows on the device
(``tbl_all[slots]``), binds them to every layer, runs the model and takes
the greedy argmax on the device, so the only device->host traffic per step
is the engine's readback of one int32 per row.  Where the JAX package
donates the KV pool through a jit, these steps update the pool in place
(``serving.kv_pages.paged_write``) and return the same cache tree.

Where the JAX package compiles each step once per bucket shape
(``jax.jit``), the engine on CUDA wraps each step in a `CapturedStep`: one
CUDA graph per step shape, captured at the shape's first call and replayed
on every later one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..kernels import ops
from ..models.transformer import _logits, decode_step, forward, prefill
from ..serving.kv_pages import with_block_tables, with_token_slots


def make_serving_steps(cfg, rt):
    """(prefill, tail_prefill, decode) steps, each
    ``step(params, tokens, caches, positions, tbl_all, slots)
    -> (next_tokens [B] int32, caches)``.

    ``tbl_all`` [max_batch, pages_per_seq] is the engine's device-resident
    table pool and ``slots`` [B] the batch rows' slots.  The tail-prefill
    step runs prefill with ``rt.prefill_over_cache``: the suffix queries of
    a prefix-cache hit attend over the gathered page pool."""
    vocab = cfg.vocab
    rt_tail = dataclasses.replace(rt, prefill_over_cache=True)

    def greedy(logits):
        return torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)

    def make_prefill(rt_used):
        @torch.inference_mode()
        def prefill_step(params, tokens, caches, positions, tbl_all, slots):
            caches = with_block_tables(caches,
                                       tbl_all.index_select(0, slots.long()))
            logits, caches = prefill(params, tokens, cfg, rt_used, caches,
                                     positions)
            return greedy(logits), caches

        return prefill_step

    @torch.inference_mode()
    def dec_step(params, token, caches, positions, tbl_all, slots):
        caches = with_block_tables(caches,
                                   tbl_all.index_select(0, slots.long()))
        logits, caches = decode_step(params, token, cfg, rt, caches,
                                     positions)
        return greedy(logits), caches

    return make_prefill(rt), make_prefill(rt_tail), dec_step


def make_ragged_step(cfg, rt):
    """The ragged token-major step:
    ``step(params, tokens, caches, positions, tbl_all, slots, emit_rows)
    -> (next_tokens [max_batch] int32, caches)``.

    tokens / positions [1, T] are a flat pack of prefill-chunk and decode
    rows, ``slots`` [T] each row's table row (-1 = padding).  ``emit_rows``
    [max_batch] names, per slot, the packed row whose logits give that
    request's next token (-1 = no emission this step: its prefill has
    chunks to go, or the slot is empty); the tied logits run only on those
    rows, and their greedy argmax stays on the device (-1 where nothing is
    emitted)."""
    vocab = cfg.vocab

    @torch.inference_mode()
    def ragged_step(params, tokens, caches, positions, tbl_all, slots,
                    emit_rows):
        caches = with_token_slots(caches, tbl_all, slots)
        hidden, caches = forward(params, tokens, cfg, rt, positions, caches,
                                 update_cache=True, return_hidden=True)
        h = hidden.index_select(1, emit_rows.clamp(min=0).long())  # [1,mb,D]
        logits = _logits(params, h, cfg, rt)[0]                    # [mb, Vp]
        nxt = torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)
        return torch.where(emit_rows >= 0, nxt, -1), caches

    return ragged_step


# ------------------------------------------------------- captured steps --
#: the positional arguments of a step that change from step to step (tokens,
#: positions, slots and, for the ragged step, emit_rows); params (0), caches
#: (2) and tbl_all (4) are read and written in place
STEP_ARGS = (1, 3, 5, 6)


def cuda_graph_capture(pool) -> Callable:
    """``capture(graph, run)``: record ``run()``'s launches into ``graph``
    (a ``torch.cuda.CUDAGraph``) with its allocations in the memory pool
    `pool` (``torch.cuda.graph_pool_handle()``), on PyTorch's capture
    stream, which every kernel wrapper launches on (``_build.stream_of``).
    Capture executes nothing."""
    def capture(graph, run):
        with torch.cuda.graph(graph, pool=pool):
            run()

    return capture


def _storage(params, caches, tbl_all) -> tuple:
    """The addresses a captured graph reads and writes in place: every
    parameter tensor, every pool leaf of `caches` (the bound routing leaves
    "tbl" and "slots" are per-call values, skipped) and the table pool."""
    ptrs: List[int] = []

    def walk(node):
        if isinstance(node, dict):
            for key, val in node.items():
                if key not in ("tbl", "slots"):
                    walk(val)
        elif isinstance(node, (list, tuple)):
            for val in node:
                walk(val)
        elif isinstance(node, torch.Tensor):
            ptrs.append(node.data_ptr())

    walk(params)
    walk(caches)
    ptrs.append(tbl_all.data_ptr())
    return tuple(ptrs)


class _Graph:
    """One step shape's graph: its static input buffers (and pinned host
    staging for them on CUDA), its static output and the kernel launches one
    replay makes."""

    def __init__(self, ins: List[torch.Tensor], device: torch.device):
        self.static = [torch.empty(t.shape, dtype=t.dtype, device=device)
                       for t in ins]
        cuda = device.type == "cuda"
        self.staging = [torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
                        for t in ins]
        # the last host->device copy out of `staging`: the host writes the
        # staging again only once that copy has read it
        self.copied = torch.cuda.Event() if cuda else None
        self.graph = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}

    def load(self, ins: List[torch.Tensor]) -> None:
        """Copy this call's inputs into the static buffers: host tensors
        through the pinned staging, asynchronously; device tensors
        directly."""
        if self.copied is not None:
            self.copied.synchronize()
        for dst, host, src in zip(self.static, self.staging, ins):
            if src.device == dst.device:
                dst.copy_(src)
            else:
                host.copy_(src)
                dst.copy_(host, non_blocking=True)
        if self.copied is not None:
            self.copied.record()


class CapturedStep:
    """A serving step captured in a graph per step shape and replayed: the
    port's counterpart of ``jax.jit(step, donate_argnums=(2,))``.

    Called as the step it wraps, ``(params, tokens, caches, positions,
    tbl_all, slots[, emit_rows]) -> (next_tokens, caches)``.  Graphs are
    keyed by the shapes and dtypes of the per-step inputs (`STEP_ARGS`,
    host or device tensors).  ``params``, the pool leaves of ``caches`` and
    ``tbl_all`` are read and written in place by every graph, so they must
    be the same storage on every call (the donation of the JAX step): a
    call that hands over other storage raises.

    The first call of a shape copies its inputs into new static buffers,
    runs the step eagerly on them (the real step, and the warm-up: kernel
    libraries load, shared-memory attributes are set, the allocator grows)
    and then captures the step on the same buffers (capture executes
    nothing, so no K/V is written twice).  Every later call of the shape
    copies its inputs into the buffers and replays the graph.  The result
    of a replay is the graph's static output, overwritten by the shape's
    next replay: the caller reads it first (the engine copies each step's
    tokens to the host before the next step).

    Kernel launch counts (``ops.launch_counts``) are incremented in Python
    by the wrappers, which a replay does not run: the counts a capture
    adds are taken back and added again on every replay, so they equal
    the eager step's.

    ``capture(graph, run)`` records ``run()`` into ``graph()``, a new
    graph object with a ``replay()`` method: `cuda_graph_capture` and
    ``torch.cuda.CUDAGraph`` on the card.  A capture or replay that fails
    raises; there is no eager fallback."""

    def __init__(self, fn: Callable, device, capture: Callable,
                 graph: Callable):
        self.fn = fn
        self.device = torch.device(device)
        self.capture = capture
        self.graph = graph
        self._graphs: Dict[tuple, _Graph] = {}
        self._storage: Optional[tuple] = None

    def _cache_size(self) -> int:
        """The number of captured graphs (read by ``JitWatch`` as a jit's
        cache size)."""
        return len(self._graphs)

    @torch.inference_mode()
    def __call__(self, params, tokens, caches, positions, tbl_all, slots,
                 *emit_rows):
        storage = _storage(params, caches, tbl_all)
        if self._storage is None:
            self._storage = storage
        elif storage != self._storage:
            raise ValueError(
                "CapturedStep: params, the KV pools and the table pool must "
                "be the same storage on every call (the captured graphs "
                "read and write them in place)")
        args = [params, tokens, caches, positions, tbl_all, slots,
                *emit_rows]
        ins = [args[i] for i in STEP_ARGS if i < len(args)]
        key = tuple((tuple(t.shape), t.dtype) for t in ins)
        g = self._graphs.get(key)
        if g is None:
            return self._first_call(key, args, ins), caches
        g.load(ins)
        g.graph.replay()
        ops.add_launch_counts(g.launches)
        return g.out, caches

    def _first_call(self, key, args, ins) -> torch.Tensor:
        g = _Graph(ins, self.device)
        g.load(ins)
        for i, buf in zip(STEP_ARGS, g.static):
            args[i] = buf
        out, _ = self.fn(*args)
        g.out = torch.empty_like(out)

        def run():
            step_out, _ = self.fn(*args)
            g.out.copy_(step_out)

        before = ops.launch_counts()
        g.graph = self.graph()
        self.capture(g.graph, run)
        after = ops.launch_counts()
        g.launches = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
        ops.add_launch_counts({k: -n for k, n in g.launches.items()})
        self._graphs[key] = g
        return out
