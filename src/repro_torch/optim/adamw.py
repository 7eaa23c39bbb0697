"""AdamW with decoupled weight decay and global-norm clipping (PyTorch port
of ``repro/optim/adamw.py``): plain functions on dict trees of tensors.

The state is the JAX package's tree, ``{"mu": <params-shaped f32>, "nu":
<params-shaped f32>, "step": int32 scalar}``, so it checkpoints under the
same keys, and the arithmetic is the JAX package's op for op: the bias
corrections ``1 - b ** step`` in float32, ``(mu / b1c) / (sqrt(nu / b2c) +
eps)``, then ``p - lr * (update + wd * p)`` in float32.  Leaves are walked
in the order ``jax.tree_util`` flattens the tree (dict keys sorted), which
fixes the order of the global norm's sum.  ``torch.optim.AdamW`` rounds in
another order and keeps its state in another layout, so it does not stand
in.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict (keys sorted at every level, as
    ``jax.tree_util`` orders them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, it):
    """`tree`'s structure with its leaves taken from the iterator `it` in
    `tree_leaves`' order."""
    if isinstance(tree, dict):
        return {k: tree_unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def adamw_init(params) -> Dict[str, Any]:
    """Zero moments shaped like `params` (f32, on each leaf's device) and
    step 0."""
    some = tree_leaves(params)[0]
    return {"mu": tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                 device=x.device), params),
            "nu": tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                 device=x.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (f32)."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(g.to(torch.float32) ** 2)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, norm=global_norm):
    """(grads scaled to a global norm of at most `max_norm`, as f32; the
    norm before clipping).  `norm` computes the norm (a sharded tree's
    sums over its shards: ``distributed.sharding.sharded_global_norm``)."""
    gn = norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


def adamw_update(params, grads, opt_state: Dict[str, Any], lr: torch.Tensor,
                 *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 norm=global_norm
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params in their dtypes, new state,
    ``{"grad_norm": the norm before clipping}``); `norm` as in
    `clip_by_global_norm`."""
    grads, gn = clip_by_global_norm(grads, max_grad_norm, norm)
    step = opt_state["step"] + 1
    sf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=sf.device), sf)
    b2c = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=sf.device), sf)

    def upd(p, g, mu, nu):
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        update = (mu / b1c) / (torch.sqrt(nu / b2c) + eps)
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (update + weight_decay * p32)
        return p32.to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, opt_state["mu"], opt_state["nu"])
    return (_pick(out, 0), {"mu": _pick(out, 1), "nu": _pick(out, 2),
                            "step": step}, {"grad_norm": gn})


def _pick(tree, i: int):
    """The i-th item of every tuple leaf of `tree`."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
