"""Step functions for the trainer, the model and the continuous-batching
engine (PyTorch port of ``repro/launch/steps.py``: ``init_train_state``,
``make_train_step``, ``make_prefill_step``, ``make_decode_step``,
``make_serving_steps`` for both KV layouts and ``make_ragged_step``).

The train step runs under autograd (never under ``inference_mode`` or
``no_grad``): `models.transformer.lm_loss`, its gradient by
``torch.autograd.grad`` over the parameters' float leaves, then
``optim.adamw_update`` at the ``warmup_cosine`` rate of the state's step.
No kernel runs in it: the training path is PyTorch's own ops, as the JAX
trainer is XLA's (QAT goes through the ``fake_quant`` straight-through
estimator; ``int_sim`` through ``backends.int_gemm``).

Each paged serving step gathers the batch's block-table rows on the device
(``tbl_all[slots]``), binds them to every layer, runs the model and takes
the greedy argmax on the device, so the only device->host traffic per step
is the engine's readback of one int32 per row.  Where the JAX package
donates the KV pool through a jit, these steps update the pool in place
(``serving.kv_pages.paged_write``) and return the same cache tree.

The contiguous serving steps take the engine's whole cache tree and the
batch's slots, and move the rows inside the step, where the JAX engine
moves them around its jitted steps: prefill runs on a fresh reset row and
scatters it into its slot; decode gathers the batch's rows, steps them and
scatters them back (``index_select`` / ``index_copy_`` on the engine's own
tensors, so a captured graph reads and writes the same storage every
call).  A row whose last position is negative (padding, warm-up) writes
back what it read; rows the step does not name are untouched.

The placement trees (`input_specs`, `_shard_cache_specs`, `state_specs`,
`param_specs_only`) describe a cell's step inputs without allocating them:
`TensorSpec` leaves (the port's ``jax.ShapeDtypeStruct`` with a sharding)
holding the global shape and dtype, the rules' spec tuple and this rank's
local shape.  The shapes are read from tensors made under a
``FakeTensorMode`` (no storage).  ``launch.dryrun`` builds its fake step
inputs at those local shapes.

Where the JAX package compiles each step once per bucket shape
(``jax.jit``), the engine on CUDA wraps each step in a `CapturedStep`: one
CUDA graph per step shape, captured at the shape's first call and replayed
on every later one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import torch

from ..distributed.sharding import (NamedSharding, dp_axes,
                                    make_param_shardings, mesh_context,
                                    sharded_global_norm, specs_to_shardings,
                                    sync_grads, zero_dims, zero_gather,
                                    zero_slice)
from ..kernels import ops
from ..models.transformer import (_logits, decode_step, forward,
                                  init_caches, init_model, lm_loss, prefill)
from ..optim import adamw_init, adamw_update, warmup_cosine
from ..optim.adamw import tree_leaves, tree_map, tree_unflatten
from ..serving.kv_pages import (gather_rows, scatter_rows, with_block_tables,
                                with_token_slots)


# ------------------------------------------------------------- train state --
#: the quant backends a train step differentiates: PyTorch ops end to end
#: (``int_sim`` and ``pallas_int4`` through ``core.backends.int_gemm``)
TRAINABLE_BACKENDS = frozenset({"float", "fake_quant", "int_sim",
                                "pallas_int4"})


def init_train_state(gen: torch.Generator, cfg, device=None) -> Dict:
    """``{"params", "opt", "step"}``: the port's random f32 parameters
    drawn from `gen` (on its device), moved to `device` when it is given,
    zero AdamW moments and step 0 (the JAX package's tree)."""
    params = init_model(gen, cfg)
    if device is not None:
        params = tree_map(lambda t: t.to(device), params)
    dev = next(iter(params["embed"].values())).device
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_train_step(cfg, rt, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, shardings=None):
    """``train_step(state, batch) -> (new_state, metrics)`` on tokens
    [B, S+1]: the loss and its gradient, then one AdamW step at the
    schedule's rate for the state's step.  Under a mesh
    (``distributed.sharding.mesh_context``) the state holds this rank's
    shards placed by the rules, `shardings` is the state's
    ``NamedSharding`` tree (``{"params", "opt": {"mu", "nu", "step"},
    "step"}``: `state_specs`, or `train_shardings` of the parameters'
    ``distributed.sharding.place``) and `batch` this data rank's rows of
    the global batch: the gradients are summed over the data axes and
    clipped by the global norm over every shard.  The step takes its
    layout from `shardings`: where the moments' shardings split a leaf
    over ``data`` and its parameter's do not (ZeRO, ``state_specs(zero=
    True)``), the leaf's gradient is reduce-scattered over ``data`` onto
    the moments' shard (not all-reduced), AdamW updates that shard of the
    parameter, and the updated shard is all-gathered over ``data``; the
    norm counts every element once.  `metrics` holds ``loss``,
    ``nll``, ``aux``, ``lr`` and ``grad_norm`` (tensors on the device).
    A parameter the loss does not reach gets a zero gradient, as under
    ``jax.grad``.  Plans whose GEMMs only a kernel computes (lut4, w4a16,
    the pre-packed and netlist backends) are refused: no kernel has a
    backward."""
    from ..core.quant_plan import active_plan

    untrainable = active_plan(cfg, rt).backends - TRAINABLE_BACKENDS
    if untrainable:
        raise NotImplementedError(
            f"make_train_step: backends {sorted(untrainable)} have no "
            f"backward; train with {sorted(TRAINABLE_BACKENDS)}")

    def train_step(state: Dict, batch: torch.Tensor):
        live = tree_map(lambda p: p.detach().requires_grad_(True),
                        state["params"])
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss, metrics = lm_loss(live, batch, cfg, rt)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, grads)])
        grads = _like(live, it)
        with torch.no_grad():
            kw, params = {}, state["params"]
            if shardings is not None:
                moments = shardings["opt"]["mu"]
                zero = zero_dims(shardings["params"], moments)
                grads = sync_grads(grads, shardings["params"], zero)
                kw["norm"] = functools.partial(sharded_global_norm,
                                               shardings=moments)
                params = zero_slice(params, zero)
            lr = warmup_cosine(state["step"], peak_lr=peak_lr,
                               warmup_steps=warmup, total_steps=total_steps)
            params, opt, info = adamw_update(params, grads, state["opt"],
                                             lr, **kw)
            if shardings is not None:
                params = zero_gather(params, zero)
        out = {"loss": loss.detach(), "lr": lr,
               **{k: v.detach() for k, v in metrics.items()}, **info}
        return {"params": params, "opt": opt, "step": state["step"] + 1}, out

    return train_step


#: `tree`'s structure with its leaves taken from an iterator
_like = tree_unflatten


def make_prefill_step(cfg, rt):
    """``step(params, tokens, caches, positions=None) -> (last logits,
    caches)``: `models.transformer.prefill` under `cfg` and `rt`."""
    @torch.inference_mode()
    def prefill_step(params, tokens, caches, positions=None):
        return prefill(params, tokens, cfg, rt, caches, positions)

    return prefill_step


def make_decode_step(cfg, rt):
    """``step(params, token, caches, positions) -> (logits, caches)``:
    `models.transformer.decode_step` under `cfg` and `rt`."""
    @torch.inference_mode()
    def step(params, token, caches, positions):
        return decode_step(params, token, cfg, rt, caches, positions)

    return step


def _keep_rows(new: Dict, old: Dict, keep: torch.Tensor) -> Dict:
    """`new`'s rows where `keep` [n] holds, `old`'s elsewhere (rep leaves
    carry the batch at dim 1, tail leaves at dim 0)."""
    def walk(a, b, dim):
        out = {}
        for key, val in a.items():
            if isinstance(val, dict):
                out[key] = walk(val, b[key], dim)
            else:
                shape = [1] * val.dim()
                shape[dim] = keep.shape[0]
                out[key] = torch.where(keep.reshape(shape), val,
                                       b[key].to(val.dtype))
        return out

    return {"rep": walk(new["rep"], old["rep"], 1),
            "tail": walk(new["tail"], old["tail"], 0)}


def make_serving_steps(cfg, rt, paged: bool = False, max_ctx: int = 0):
    """(prefill, tail_prefill, decode) steps, each
    ``step(params, tokens, caches, positions, tbl_all, slots)
    -> (next_tokens [B] int32, caches)``.

    ``paged=True``: ``tbl_all`` [max_batch, pages_per_seq] is the engine's
    device-resident table pool and ``slots`` [B] the batch rows' slots.
    The tail-prefill step runs prefill with ``rt.prefill_over_cache``: the
    suffix queries of a prefix-cache hit attend over the gathered page
    pool.

    ``paged=False`` (the contiguous layout): ``caches`` is the engine's
    whole cache tree of `max_ctx`-long rows, ``tbl_all`` is None and
    ``slots`` [B] (distinct) the rows the batch runs on.  Prefill (B == 1)
    runs on a fresh row (``init_caches``) and scatters it into its slot;
    decode gathers the rows, steps them and scatters them back; a row whose
    last position is negative writes back what it read.  The tail-prefill
    step is None (no pages to share)."""
    vocab = cfg.vocab

    def greedy(logits):
        return torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)

    if not paged:
        @torch.inference_mode()
        def prefill_rows(params, tokens, caches, positions, tbl_all, slots):
            rows = slots.long()
            fresh = init_caches(cfg, rt, batch=rows.shape[0], seq=max_ctx,
                                device=tokens.device)
            logits, row = prefill(params, tokens, cfg, rt, fresh, positions)
            keep = positions[:, -1] >= 0
            scatter_rows(caches, _keep_rows(row, gather_rows(caches, rows),
                                            keep), rows)
            return greedy(logits), caches

        @torch.inference_mode()
        def decode_rows(params, token, caches, positions, tbl_all, slots):
            rows = slots.long()
            sub = gather_rows(caches, rows)
            logits, new = decode_step(params, token, cfg, rt, sub, positions)
            keep = positions[:, -1] >= 0
            scatter_rows(caches, _keep_rows(new, sub, keep), rows)
            return greedy(logits), caches

        return prefill_rows, None, decode_rows

    rt_tail = dataclasses.replace(rt, prefill_over_cache=True)

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


# ------------------------------------------------------------ input specs --
@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor described, not allocated: its global `shape` and `dtype`,
    its `spec` (a ``distributed.sharding`` spec tuple; None without a
    mesh) and `local_shape`, this rank's shard's shape under the mesh."""
    shape: tuple
    dtype: torch.dtype
    spec: Optional[tuple] = None
    local_shape: Optional[tuple] = None


def _sds(shape, dtype, spec=None, mesh=None) -> TensorSpec:
    """A `TensorSpec` of `shape` placed by `spec` on `mesh`: each sharded
    dimension divided by the size of its axes (which must divide it)."""
    shape = tuple(int(d) for d in shape)
    if mesh is None or spec is None:
        return TensorSpec(shape, dtype, None if mesh is None else spec,
                          shape)
    spec = tuple(spec)
    local = list(shape)
    for d, e in enumerate(spec):
        if e is not None:
            n = mesh.size(e)
            if local[d] % n:
                raise ValueError(f"dim {d} of {shape} does not divide over "
                                 f"{e} ({n})")
            local[d] //= n
    return TensorSpec(shape, dtype, spec, tuple(local))


def _abstract(fn):
    """``fn()``'s tree with every tensor made under a fresh
    ``FakeTensorMode``: shapes and dtypes, no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return fn()


def _specs_tree(tree, specs, mesh):
    """A `TensorSpec` tree of the tensors of `tree` under the spec tree
    `specs` (tuples)."""
    if isinstance(tree, dict):
        return {k: _specs_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_specs_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return _sds(tree.shape, tree.dtype, specs, mesh)


def _dp_spec(mesh):
    dpa = dp_axes() if mesh is not None else ()
    if not dpa:
        return None
    return dpa if len(dpa) > 1 else dpa[0]


def input_specs(cfg, shape, mesh=None, rt=None) -> Dict:
    """`TensorSpec` stand-ins for the cell's step-function inputs: the
    train batch [B, S+1], or the prompt [B, S] and the contiguous caches,
    or the decode token and positions [B, 1] and the caches of context S.
    Each data rank holds B / dp rows where dp divides B, else all B."""
    from ..configs import Runtime

    rt = rt or Runtime()
    B, S = shape.batch, shape.seq

    def tok(shp, b):
        if mesh is None:
            return _sds(shp, torch.int32)
        dspec = _dp_spec(mesh)
        return _sds(shp, torch.int32,
                    (dspec if b % mesh.size(dspec) == 0 else None, None),
                    mesh)

    with mesh_context(mesh):
        if shape.kind == "train":
            return {"batch": tok((B, S + 1), B)}
        caches = _abstract(lambda: init_caches(cfg, rt, batch=B, seq=S,
                                               device="cpu"))
        caches = _shard_cache_specs(caches, mesh)
        if shape.kind == "prefill":
            return {"tokens": tok((B, S), B), "caches": caches}
        if shape.kind == "decode":
            return {"token": tok((B, 1), B), "caches": caches,
                    "positions": tok((B, 1), B)}
    raise ValueError(shape.kind)


def _shard_cache_specs(caches, mesh):
    """KV/state caches: shard the *batch* dim over data when divisible.
    Stacked per-repeat caches are [n_repeats, B, ...] (batch at dim 1);
    tail-block caches are [B, ...] (batch at dim 0)."""
    if mesh is None:
        return _specs_tree(caches, tree_map(lambda t: None, caches), None)
    dspec = _dp_spec(mesh)
    size = mesh.size(dspec) if dspec is not None else 1

    def shard_leaf(batch_dim):
        def inner(leaf):
            ax = [None] * leaf.dim()
            if leaf.dim() > batch_dim and leaf.shape[batch_dim] % size == 0 \
                    and leaf.shape[batch_dim] > 1:
                ax[batch_dim] = dspec
            return _sds(leaf.shape, leaf.dtype, tuple(ax), mesh)
        return inner

    return {"rep": tree_map(shard_leaf(1), caches["rep"]),
            "tail": tree_map(shard_leaf(0), caches["tail"])}


@functools.lru_cache(maxsize=4)
def _abstract_state(cfg) -> Dict:
    """The train state of `cfg` as fake tensors (shapes and dtypes; kept,
    since an MoE config's full-width draw takes seconds even so)."""
    return _abstract(lambda: init_train_state(
        torch.Generator().manual_seed(0), cfg))


def train_shardings(param_shardings, mesh) -> Dict:
    """The train state's ``NamedSharding`` tree with the AdamW moments
    placed as their parameters (`param_shardings`; the trainer CLI's
    layout, ``state_specs(zero=False)``)."""
    whole = NamedSharding(mesh, ())
    return {"params": param_shardings, "step": whole,
            "opt": {"mu": param_shardings, "nu": param_shardings,
                    "step": whole}}


def state_specs(cfg, mesh, *, zero: bool = True):
    """(`TensorSpec` tree, ``NamedSharding`` tree) of the full train state;
    `zero` shards the AdamW moments over ``data`` too (ZeRO)."""
    state = _abstract_state(cfg)
    pspecs = make_param_shardings(state["params"], mesh)
    ospecs = {
        "mu": make_param_shardings(state["opt"]["mu"], mesh, zero=zero),
        "nu": make_param_shardings(state["opt"]["nu"], mesh, zero=zero),
        "step": (),
    }
    specs = {"params": pspecs, "opt": ospecs, "step": ()}
    return _specs_tree(state, specs, mesh), specs_to_shardings(specs, mesh)


def param_specs_only(cfg, mesh):
    """(`TensorSpec` tree, ``NamedSharding`` tree) of the f32 parameters."""
    params = _abstract_state(cfg)["params"]
    specs = make_param_shardings(params, mesh)
    return (_specs_tree(params, specs, mesh),
            specs_to_shardings(specs, mesh))


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
    "tbl" and "slots" are per-call values, skipped) and the table pool
    (None for the contiguous layout)."""
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
    if tbl_all is not None:
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
