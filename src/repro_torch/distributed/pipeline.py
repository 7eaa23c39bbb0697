"""GPipe-style pipeline parallelism over a mesh ``stage`` axis (PyTorch port
of ``repro/distributed/pipeline.py``).

`pipeline_apply` runs a per-stage step function over microbatches, one
stage a rank: the classic GPipe fill/drain schedule of ``n_micro +
n_stages - 1`` ticks.  At each tick stage 0 takes microbatch t (clamped,
as the JAX package's ``jnp.clip``), every other stage the activation its
predecessor sent at the last tick; each stage applies its function and
passes the result to the next stage round the ring (the JAX package's
``ppermute``), as one ``batch_isend_irecv`` of a send and a receive, so
no two ranks both block on a send.  The last stage keeps microbatch ``t -
(n_stages - 1)``'s output; an all-reduce over the stages replicates the
outputs (every other stage contributes zeros).

The schedule is differentiable with respect to the stacked parameters and
the input (`_Pipeline`, one ``autograd.Function``).  Its forward keeps
each tick's local graph of the stage function; its backward runs the ticks
in reverse: at each tick every stage shifts the gradient of its next
tick's input back round the ring (to the previous stage, receiving from
the next), adds its emitted output's gradient on the last stage, and takes
the stage function's vector-Jacobian product.  Every rank runs the same
sequence of shifts, so no rank waits on a peer that skipped one.  The
final all-reduce's gradient passes through (the outputs are replicated, so
each rank holds the whole gradient), and the replicated input and stacked
parameters enter as copies whose gradients are summed over the stages:
each rank ends with the sequential model's gradient of every stage's
parameters and of the input.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List

import torch
import torch.distributed as dist

from .sharding import record_collective


def pipeline_apply(stage_fn: Callable, params_stacked, x: torch.Tensor, *,
                   mesh, n_micro: int, stage_axis: str = "stage"
                   ) -> torch.Tensor:
    """x [n_micro * micro_batch, ...] through ``n_stages`` sequential
    ``stage_fn(stage_params, x_microbatch)`` calls, pipelined over the
    microbatches.  `params_stacked` is a tensor or a dict of tensors, each
    leaf [n_stages, ...]: this rank takes its stage's slice.  Returns the
    outputs [n_micro * micro_batch, ...] on every rank; differentiable
    with respect to `x` and `params_stacked`."""
    if x.shape[0] % n_micro:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_micro} "
                         "microbatches")
    leaves: List[torch.Tensor] = []
    spec = _flatten(params_stacked, leaves)
    plan = (stage_fn, spec, mesh, stage_axis, n_micro)
    return _Pipeline.apply(plan, x, *leaves)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x, *leaves):
        stage_fn, spec, mesh, stage_axis, n_micro = plan
        n_stages = mesh.shape[stage_axis]
        group = mesh.group(stage_axis)
        stage = mesh.coord(stage_axis)
        ranks = dist.get_process_group_ranks(group)
        nxt = ranks[(stage + 1) % n_stages]
        prv = ranks[(stage - 1) % n_stages]
        track = any(ctx.needs_input_grad[1:])
        local = [leaf[stage].detach().requires_grad_(track)
                 for leaf in leaves]
        params = _unflatten(spec, iter(local))
        xs = x.detach().reshape(n_micro, x.shape[0] // n_micro,
                                *x.shape[1:])
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        ticks = []
        for t in range(n_micro + n_stages - 1):
            inp = xs[min(t, n_micro - 1)] if stage == 0 else buf
            if track:
                inp = inp.detach().requires_grad_(True)
            with torch.enable_grad() if track else contextlib.nullcontext():
                y = stage_fn(params, inp).contiguous()
            if track:
                ticks.append((inp, y))
            y = y.detach()
            if n_stages > 1:
                buf = _shift(y, nxt, prv, group)
            emit = t - (n_stages - 1)
            if emit >= 0 and stage == n_stages - 1:
                outs[emit] = y
        if n_stages > 1:
            record_collective("all-reduce", outs, group)
            dist.all_reduce(outs, group=group)
        ctx.plan = (n_stages, group, stage, nxt, prv, n_micro)
        ctx.ticks, ctx.local = ticks, local
        ctx.shapes = (tuple(x.shape), [tuple(t.shape) for t in leaves])
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, g_out):
        n_stages, group, stage, nxt, prv, n_micro = ctx.plan
        x_shape, leaf_shapes = ctx.shapes
        ticks, local = ctx.ticks, ctx.local
        # the replicated outputs' gradient passes the all-reduce as it is
        g = g_out.reshape(n_micro, x_shape[0] // n_micro, *x_shape[1:])
        g_local = [torch.zeros_like(p) for p in local]
        g_xs = torch.zeros_like(g)
        g_send = torch.zeros_like(g[0])
        for t in reversed(range(len(ticks))):
            inp, y = ticks[t]
            # dL/dy_t: what the next stage's tick t + 1 input received
            gy = (_shift(g_send, prv, nxt, group) if n_stages > 1
                  else torch.zeros_like(y))
            emit = t - (n_stages - 1)
            if emit >= 0 and stage == n_stages - 1:
                gy = gy + g[emit]
            grads = torch.autograd.grad(y, [inp, *local], gy,
                                        allow_unused=True)
            g_inp = grads[0] if grads[0] is not None else \
                torch.zeros_like(inp)
            for acc, gp in zip(g_local, grads[1:]):
                if gp is not None:
                    acc += gp
            if stage == 0:
                g_xs[min(t, n_micro - 1)] += g_inp
                g_send = torch.zeros_like(g_inp)
            else:
                g_send = g_inp
        ctx.ticks = ctx.local = None
        # the replicated input and stacked parameters: every stage's
        # gradient summed over the stages (one stage holds each)
        g_leaves = []
        for shape, gl in zip(leaf_shapes, g_local):
            full = gl.new_zeros(shape)
            full[stage] = gl
            g_leaves.append(full)
        if n_stages > 1:
            for t in (g_xs, *g_leaves):
                record_collective("all-reduce", t, group)
                dist.all_reduce(t, group=group)
        return (None, g_xs.reshape(x_shape), *g_leaves)


def _shift(y: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send `y` to rank `to` and receive a tensor like it from rank `frm`
    (one ``batch_isend_irecv``)."""
    recv = torch.empty_like(y)
    record_collective("collective-permute", y, group)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, y, to, group),
        dist.P2POp(dist.irecv, recv, frm, group)])
    for r in reqs:
        r.wait()
    return recv


def _flatten(tree, out: List[torch.Tensor]):
    """`tree`'s structure (a dict's keys, recursively; None for a leaf),
    appending its tensors to `out` in order."""
    if isinstance(tree, dict):
        return {k: _flatten(v, out) for k, v in tree.items()}
    out.append(tree)
    return None


def _unflatten(spec, it):
    if isinstance(spec, dict):
        return {k: _unflatten(v, it) for k, v in spec.items()}
    return next(it)
