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
outputs (every other stage contributes zeros).  Forward only: the
schedule carries no autograd across ranks.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def pipeline_apply(stage_fn: Callable, params_stacked, x: torch.Tensor, *,
                   mesh, n_micro: int, stage_axis: str = "stage"
                   ) -> torch.Tensor:
    """x [n_micro * micro_batch, ...] through ``n_stages`` sequential
    ``stage_fn(stage_params, x_microbatch)`` calls, pipelined over the
    microbatches.  `params_stacked` is a tensor or a dict of tensors, each
    leaf [n_stages, ...]: this rank takes its stage's slice.  Returns the
    outputs [n_micro * micro_batch, ...] on every rank."""
    n_stages = mesh.shape[stage_axis]
    if x.shape[0] % n_micro:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_micro} "
                         "microbatches")
    group = mesh.group(stage_axis)
    stage = mesh.coord(stage_axis)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(stage + 1) % n_stages], ranks[(stage - 1) % n_stages]
    params = _take(params_stacked, stage)
    xs = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    buf = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(n_micro + n_stages - 1):
        inp = xs[min(t, n_micro - 1)] if stage == 0 else buf
        y = stage_fn(params, inp).contiguous()
        if n_stages > 1:
            recv = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)])
            for r in reqs:
                r.wait()
            buf = recv
        emit = t - (n_stages - 1)
        if emit >= 0 and stage == n_stages - 1:
            outs[emit] = y
    if n_stages > 1:
        dist.all_reduce(outs, group=group)
    return outs.reshape(x.shape)


def _take(tree, i: int):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]
