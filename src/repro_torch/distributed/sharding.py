"""Sharding rules and the tensor-parallel collectives (PyTorch port of
``repro/distributed/sharding.py``).

The rules are data: `param_spec`, `stacked_param_spec` and
`make_param_shardings` return the JAX package's PartitionSpecs as plain
tuples (one entry a dimension: None, an axis name or a tuple of names), so
they compare with the reference exactly and need no process group; they
read only ``mesh.shape``.  `specs_to_shardings` turns a spec tree into
`NamedSharding`\\ s on a `Mesh` (a ``torch.distributed`` DeviceMesh with
named axes, ``launch.mesh``), each of which slices a full tensor into this
rank's shard, gathers a shard back, and names its DTensor placements.

Execution model: explicit, Megatron style.  Every rank holds plain local
tensors, its shard of each parameter as the rules place it (`place`), and
the model code calls the redistributions where the JAX package leaves
GSPMD to insert collectives.  DTensor was the alternative; it was not
taken because the kernel wrappers take plain contiguous tensors (a DTensor
would be unwrapped at every GEMM), because DTensor has no sharding rule
for the dispatch ops of the MoE block or for the kernels, and because the
exact row-parallel W4A4 GEMM needs its collectives at precise points (the
integer partial sums added before the scales).  A local tensor does not
carry its placement: the code that made it knows it (a column-parallel
GEMM reports whether its output is sharded, ``tensor_parallel``).

So the JAX package's ``shard(x, name)`` constraints, and its
``shard_spec``, have no counterpart here: where one of them makes GSPMD
insert a collective, the port's model code calls it, `tp_gather`,
`tp_slice` or `tp_reduce`, and where it changes nothing (an activation
already in the named layout) the port does nothing.  Batch dimensions
stay data-local: each data rank holds its slice of the batch from the
start, so only the ``model`` axis is redistributed.

Every collective the port calls goes through one of six sites: `_all_gather`,
`_all_reduce`, `sync_grads`, `sharded_global_norm` here and the pipeline's
ring shift and all-reduce (``distributed.pipeline``).  Each appends
``(kind, operand bytes, cross_pod)`` to ``COLLECTIVES.log`` while that is a
list (``launch.dryrun`` sets it; None, the default, records nothing): the
collective ledger, which stands in for the JAX dry-run's collectives
parsed from the HLO.  A collective is cross-pod when its group holds the
``pod`` axis.

Gradients follow one convention: a tensor replicated over ``model`` has
the full, identical gradient on every rank.  So an all-gather's backward takes the rank's slice, a slice's backward
all-gathers, the all-reduce of partial sums passes its gradient through,
and `tp_copy_in` (the identity) all-reduces the partial gradients of a
replicated tensor that rank-specific compute consumes.  Without a mesh
every helper returns its input: the single-device path is unchanged bit
for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import types
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

#: the active mesh, process-wide: on CUDA the autograd engine runs the
#: backward, and a rematerialized block's recomputation, on its own threads,
#: which must see the mesh the forward ran under (a thread-local slot, as
#: the JAX package keeps, would read None there)
_state = types.SimpleNamespace(mesh=None)

TP = "model"

#: the collective ledger: ``log`` is None (nothing recorded) or a list that
#: every collective site appends ``(kind, operand bytes, cross_pod)`` to;
#: kinds are the JAX roofline's (``all-reduce``, ``all-gather``,
#: ``collective-permute``)
COLLECTIVES = types.SimpleNamespace(log=None)


def record_collective(kind: str, t: torch.Tensor, group) -> None:
    """One collective of `kind` on operand `t` over `group` into the
    ledger, when it is on."""
    log = COLLECTIVES.log
    if log is not None:
        log.append((kind, t.numel() * t.element_size(), _spans_pod(group)))


def _spans_pod(group) -> bool:
    """Whether `group` is one of the current mesh's groups over ``pod``."""
    m = current_mesh()
    return m is not None and any(
        "pod" in axes and g is group for axes, g in m._groups.items())


class Mesh:
    """Named axes over the ranks of the default process group, row-major
    (the last axis varies fastest), as ``jax.sharding.Mesh`` lays out its
    devices.  `shape` maps each axis to its size.  Built by
    ``launch.mesh.make_mesh`` on a ``DeviceMesh``; ``Mesh(shape)`` without
    one is a shape-only mesh for the rules."""

    def __init__(self, shape: Dict[str, int], device_mesh=None,
                 device: Optional[torch.device] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device_mesh = device_mesh
        self.device = device
        self._groups: Dict[Tuple[str, ...], object] = {}
        if device_mesh is not None:
            for a in self.axis_names:
                self._groups[(a,)] = device_mesh.get_group(a)
            if len(self.axis_names) == 3:          # the pod + data group
                self._groups[self.axis_names[:2]] = _flat_group(
                    device_mesh, self.axis_names[:2])

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def size(self, axes) -> int:
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def coord(self, axes) -> int:
        """This rank's index along `axes` (several axes: row-major)."""
        c = self.device_mesh.get_coordinate()
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + c[self.axis_names.index(a)]
        return idx

    def group(self, axes):
        return self._groups[_axes(axes)]


def _flat_group(device_mesh, axes):
    """One process group over several mesh axes, ranks in row-major order
    of those axes."""
    return device_mesh[axes]._flatten().get_group()


def _axes(axes) -> Tuple[str, ...]:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def current_mesh() -> Optional[Mesh]:
    return _state.mesh


def dp_axes() -> Tuple[str, ...]:
    m = current_mesh()
    if m is None:
        return ()
    return ("pod", "data") if "pod" in m.axis_names else ("data",)


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh]):
    prev = _state.mesh
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def tp_size() -> int:
    m = current_mesh()
    return m.shape[TP] if m is not None else 1


def tp_rank() -> int:
    m = current_mesh()
    return m.coord(TP) if m is not None and m.shape[TP] > 1 else 0


def dp_size() -> int:
    m = current_mesh()
    return m.size(dp_axes()) if m is not None else 1


def dp_rank() -> int:
    m = current_mesh()
    return m.coord(dp_axes()) if m is not None and dp_size() > 1 else 0


def _has(entry, axis: str) -> bool:
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def _padded(spec, ndim: int) -> Tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


# ------------------------------------------------ model-axis collectives --
def _group():
    return current_mesh().group(TP)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    record_collective("all-gather", x, group)
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    record_collective("all-reduce", x, group)
    dist.all_reduce(x, op=op, group=group)
    return x


class _Reduce(torch.autograd.Function):
    """Partial sums -> replicated (all-reduce); the gradient passes."""
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    """Identity; the replicated input's partial gradients are summed."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """Shards along `dim` -> replicated; the gradient takes the slice."""
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


class _Slice(torch.autograd.Function):
    """Replicated -> this rank's shard along `dim`; the gradient is
    gathered."""
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _GatherSum(torch.autograd.Function):
    """Shards along `dim` -> the whole tensor, consumed by rank-specific
    compute: the backward is the reduce-scatter (sum, then the slice)."""
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(_all_reduce(g, ctx.group), ctx.dim, ctx.group), \
            None, None


def tp_copy_in(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor entering rank-specific compute (a column-parallel
    GEMM, seq-sharded attention): forward unchanged, partial gradients
    summed over ``model``."""
    if tp_size() <= 1:
        return x
    return _CopyIn.apply(x, _group())


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    """Partial sums over ``model`` -> their sum on every rank."""
    if tp_size() <= 1:
        return x
    return _Reduce.apply(x, _group())


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    if tp_size() <= 1:
        return x
    return _Gather.apply(x, dim % x.dim(), _group())


def tp_slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    if tp_size() <= 1:
        return x
    return _Slice.apply(x, dim % x.dim(), _group())


def gather_for_compute(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """All-gather `x`'s shards over `axis` along `dim` for compute that
    differs by rank (the MoE block's FSDP gather of expert weights over
    ``data``); the backward is the matching reduce-scatter."""
    m = current_mesh()
    if m is None or m.shape[axis] <= 1:
        return x
    return _GatherSum.apply(x, dim % x.dim(), m.group(axis))


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over ``model`` (no gradient: for scales)."""
    if tp_size() <= 1:
        return x
    return _all_reduce(x.detach(), _group(), dist.ReduceOp.MAX)


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the data axes (no gradient: for reported values)."""
    m = current_mesh()
    x = x.detach()
    if m is None:
        return x
    for a in dp_axes():
        if m.shape[a] > 1:
            x = _all_reduce(x, m.group(a))
    return x


# ------------------------------------------------------------ param rules --
#: (path regex, spec builder).  Specs written for *unstacked* params; a
#: layer-stacked param (leading dim over the repeats) gets None prepended.
def param_spec(path: str, shape: Tuple[int, ...], mesh) -> Tuple:
    tp = mesh.shape[TP]

    def fits(dim_idx: int) -> bool:
        return shape[dim_idx] % tp == 0

    rules = [
        (r"embed/tok$", lambda: (TP, None) if fits(0) else (None, None)),
        (r"(lm_head|router)/w$", lambda: (None, TP) if fits(1) else ()),
        (r"w(q|k|v|kv|qkv)(/w)?$",
         lambda: (None, TP) if fits(1) else (None, None)),
        (r"w(q|k|v|qkv)_bias$", lambda: (TP,) if fits(0) else (None,)),
        (r"wo(/w)?$", lambda: (TP, None) if fits(0) else (None, None)),
        (r"ffn/(w_in|w_gate)$",
         lambda: (None, TP) if fits(1) else (None, None)),
        (r"ffn/w_out$", lambda: (TP, None) if fits(0) else (None, None)),
        (r"ffn/(b_in|b_gate)$", lambda: (TP,) if fits(0) else (None,)),
        # experts: E over TP (expert parallelism), F over data (FSDP-style,
        # gathered per layer inside the MoE block)
        (r"experts/(w_in|w_gate)$", lambda: (TP, None, "data")
            if shape[2] % mesh.shape["data"] == 0 else (TP, None, None)),
        (r"experts/w_out$", lambda: (TP, "data", None)
            if shape[1] % mesh.shape["data"] == 0 else (TP, None, None)),
        (r"(mamba|lru)/in_proj$",
         lambda: (None, TP) if fits(1) else (None, None)),
        (r"(mamba|lru)/out_proj$",
         lambda: (TP, None) if fits(0) else (None, None)),
        (r"lru/w_(a|x)$", lambda: (None, TP) if fits(1) else (None, None)),
    ]
    for pat, builder in rules:
        if re.search(pat, path):
            return builder()
    return ()                                                  # replicate


def stacked_param_spec(path: str, shape, mesh, stacked: bool) -> Tuple:
    inner_shape = shape[1:] if stacked else shape
    spec = param_spec(path, inner_shape, mesh)
    return (None,) + tuple(spec) if stacked else spec


def _flat_axes(spec) -> list:
    out = []
    for e in spec:
        out.extend(e if isinstance(e, tuple) else (e,))
    return [a for a in out if a is not None]


def make_param_shardings(params, mesh, stacked_prefixes=("layers",),
                         zero: bool = False):
    """The spec tree of a param tree (nested dicts and lists; paths joined
    with '/').  ``mu/`` and ``nu/`` prefixes (optimizer trees) and
    ``/packed``, ``/scale`` suffixes (packed serving weights) take their
    weight's rule.  `zero=True` (ZeRO-style, for optimizer state trees)
    also shards the first yet-unsharded dimension divisible by the data
    axis's size."""
    dp = mesh.shape["data"]

    def spec_of(path: str, leaf) -> Tuple:
        rel = path
        for pre in ("mu/", "nu/"):
            if rel.startswith(pre):
                rel = rel[len(pre):]
        for suf in ("/packed", "/scale"):
            if rel.endswith(suf):
                rel = rel[: -len(suf)]
        stacked = any(rel.startswith(p) for p in stacked_prefixes)
        shape = tuple(leaf.shape)
        spec = stacked_param_spec(rel, shape, mesh, stacked)
        if zero and "data" not in _flat_axes(spec):
            ax = list(spec) + [None] * (len(shape) - len(spec))
            for d in range(len(shape)):
                if ax[d] is None and shape[d] % dp == 0 and shape[d] >= dp:
                    ax[d] = "data"
                    break
            spec = tuple(ax)
        return spec

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}" if path else str(i))
                              for i, v in enumerate(node))
        return spec_of(path, node)

    return walk(params, "")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a `Mesh`: which of this rank's slices of a full tensor it
    holds."""
    mesh: Mesh
    spec: Tuple

    def _dims(self, ndim: int):
        """(dim, axes) of every sharded dimension."""
        return [(d, _axes(e)) for d, e in enumerate(_padded(self.spec, ndim))
                if e is not None and self.mesh.size(e) > 1]

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of `full` (a contiguous copy)."""
        t = full
        for d, axes in self._dims(full.dim()):
            n = self.mesh.size(axes)
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(full.shape)} does not "
                                 f"divide over {axes} ({n})")
            size = t.shape[d] // n
            t = t.narrow(d, self.mesh.coord(axes) * size, size)
        return t.contiguous()

    def full(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's shard (collective over the
        spec's axes)."""
        t = local
        for d, axes in reversed(self._dims(local.dim())):
            t = _all_gather(t, d, self.mesh.group(axes))
        return t

    def placements(self):
        """DTensor placements, one a mesh axis (a dimension sharded over
        several axes is ``Shard(d)`` on each, in the spec's order)."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * len(self.mesh.axis_names)
        for d, e in enumerate(self.spec):
            if e is not None:
                for a in _axes(e):
                    out[self.mesh.axis_names.index(a)] = Shard(d)
        return tuple(out)


def specs_to_shardings(specs, mesh: Mesh):
    """The `NamedSharding` tree of a spec tree (a spec is a tuple leaf)."""
    if isinstance(specs, dict):
        return {k: specs_to_shardings(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [specs_to_shardings(v, mesh) for v in specs]
    return NamedSharding(mesh, tuple(specs))


def tree_local(tree, shardings):
    """Each leaf of `tree` (full tensors) sliced to this rank's shard."""
    if isinstance(tree, dict):
        return {k: tree_local(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_local(v, s) for v, s in zip(tree, shardings))
    return shardings.local(tree)


def tree_full(tree, shardings):
    """Each leaf of `tree` (this rank's shards) gathered whole (collective:
    every rank calls it)."""
    if isinstance(tree, dict):
        return {k: tree_full(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_full(v, s) for v, s in zip(tree, shardings))
    return shardings.full(tree)


def _has_twins(tree) -> bool:
    if isinstance(tree, dict):
        return "packed_km" in tree or any(_has_twins(v)
                                          for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_twins(v) for v in tree)
    return False


def place(params, mesh: Mesh):
    """(this rank's shard of every leaf of the full tree `params`, the
    `NamedSharding` tree).  Derived leaves (planar K-major twins, per-block
    views) are dropped before the rules and the twins rebuilt from the
    local shards.  A packed weight whose nibbles and scales the rules
    place differently is refused."""
    from ..checkpoint.ckpt import _strip
    from ..core.qlinear import prepack_tree

    twins = _has_twins(params)
    params = _strip(params)
    specs = make_param_shardings(params, mesh)
    _check_packed(params, specs)
    shardings = specs_to_shardings(specs, mesh)
    local = tree_local(params, shardings)
    return (prepack_tree(local) if twins else local), shardings


def _check_packed(params, specs, path: str = "") -> None:
    if isinstance(params, dict):
        if "packed" in params and "scale" in params:
            p, s = specs["packed"], specs["scale"]
            k = params["packed"].dim()
            n_p = [_has(e, TP) for e in _padded(p, k)]
            n_s = [_has(e, TP) for e in _padded(s, params["scale"].dim())]
            # columns: the last dim of both; rows: the nibbles' second to
            # last against a grouped scale's group dim (a per-channel
            # scale has one row, which no rule shards)
            col_ok = n_p[-1] == n_s[-1]
            grouped = params["scale"].dim() == k + 1
            row_ok = n_p[-2] == n_s[-3] if grouped else True
            if not (col_ok and row_ok):
                raise ValueError(
                    f"{path}: the rules place the packed nibbles {p} and "
                    f"the scales {s} inconsistently")
            return
        for k, v in params.items():
            _check_packed(v, specs[k], f"{path}/{k}")
    elif isinstance(params, (list, tuple)):
        for i, (v, s) in enumerate(zip(params, specs)):
            _check_packed(v, s, f"{path}/{i}")


def local_width(w) -> int:
    """A weight's local output width: a [.., K, N] tensor's N, a packed
    dict's scale's."""
    return (w["scale"] if isinstance(w, dict) else w).shape[-1]


def local_rows(w) -> int:
    """A weight's local input width: a [.., K, N] tensor's K, a packed
    dict's nibble rows."""
    return (w["packed"] if isinstance(w, dict) else w).shape[-2]



# ------------------------------------------------------- sharded training --
def zero_dims(param_shardings, moment_shardings) -> list:
    """For each leaf (``optim.adamw.tree_leaves`` order), the dimension
    that the moment's sharding splits over ``data`` where its parameter's
    does not (ZeRO: ``launch.steps.state_specs(zero=True)``), else None;
    None too while ``data`` has one rank."""
    from ..optim.adamw import tree_leaves

    out = []
    for p, mo in zip(tree_leaves(param_shardings),
                     tree_leaves(moment_shardings)):
        dim = None
        if mo.mesh.shape["data"] > 1 and "data" not in _flat_axes(p.spec):
            dim = next((d for d, e in enumerate(mo.spec)
                        if e is not None and "data" in _axes(e)), None)
        out.append(dim)
    return out


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of `x` over `group`, cut along `dim`: this rank's slice."""
    n = dist.get_world_size(group)
    parts = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    record_collective("reduce-scatter", x, group)
    dist.reduce_scatter(out, parts, group=group)
    return out


def sync_grads(grads, shardings, zero=None):
    """Each gradient summed over the data axes its parameter (`shardings`,
    a `NamedSharding` tree) is not sharded on: a data-sharded expert
    weight's gradient was reduce-scattered over ``data`` in the backward
    already.  Where `zero` (`zero_dims`) names a dimension, the gradient is
    reduce-scattered over ``data`` along it onto its moment's shard instead
    of all-reduced there.  Returns the gradient tree (in place where
    nothing is scattered)."""
    from ..optim.adamw import tree_leaves, tree_unflatten

    m = current_mesh()
    if m is None:
        return grads
    leaves = tree_leaves(grads)
    dims = zero or [None] * len(leaves)
    out = []
    for g, sh, dim in zip(leaves, tree_leaves(shardings), dims):
        if dim is not None:
            g = _reduce_scatter(g, dim, m.group("data"))
        have = _flat_axes(sh.spec) + ([] if dim is None else ["data"])
        for a in dp_axes():
            if a not in have and m.shape[a] > 1:
                record_collective("all-reduce", g, m.group(a))
                dist.all_reduce(g, group=m.group(a))
        out.append(g)
    return tree_unflatten(grads, iter(out))


def zero_slice(params, zero):
    """Each parameter cut to this data rank's slice along its `zero`
    dimension (`zero_dims`): the shard its moments hold."""
    from ..optim.adamw import tree_leaves, tree_unflatten

    m = current_mesh()
    return tree_unflatten(params, iter(
        p if dim is None else _chunk(p, dim, m.group("data"))
        for p, dim in zip(tree_leaves(params), zero)))


def zero_gather(params, zero):
    """The inverse of `zero_slice`: each sliced parameter all-gathered over
    ``data`` along its `zero` dimension."""
    from ..optim.adamw import tree_leaves, tree_unflatten

    m = current_mesh()
    return tree_unflatten(params, iter(
        p if dim is None else _all_gather(p, dim, m.group("data"))
        for p, dim in zip(tree_leaves(params), zero)))


def sharded_global_norm(grads, shardings) -> torch.Tensor:
    """The global norm of a tree of gradient shards: each leaf's sum of
    squares summed over the axes its gradient is sharded on (`shardings`:
    its parameter's, or under ZeRO its moment's), then the leaves summed
    in ``optim.adamw.global_norm``'s order."""
    from ..optim.adamw import tree_leaves

    m = current_mesh()
    leaves = tree_leaves(grads)
    spec_leaves = [sh.spec for sh in tree_leaves(shardings)]
    sq = torch.stack([torch.sum(g.to(torch.float32) ** 2) for g in leaves])
    if m is not None:
        for a in m.axis_names:
            flags = [a in _flat_axes(s) for s in spec_leaves]
            if m.shape[a] > 1 and any(flags):
                mask = torch.tensor(flags, device=sq.device)
                part = torch.where(mask, sq, torch.zeros_like(sq))
                record_collective("all-reduce", part, m.group(a))
                dist.all_reduce(part, group=m.group(a))
                sq = torch.where(mask, part, sq)
    total = 0
    for v in sq:
        total = total + v
    return torch.sqrt(total)
