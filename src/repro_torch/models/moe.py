"""Mixture-of-Experts block with expert parallelism (PyTorch port of
``repro/models/moe.py``: `init_moe`, `_capacity`, `_expert_ffn`,
`_moe_shard` and both branches of `apply_moe`).

Dispatch is sort-based, as in the JAX package: an f32 router, softmax,
top-k (renormalised for k > 1), a stable argsort of the flat expert ids,
each assignment's rank within its expert, capacity-bounded per-expert
buffers ``[E, C, D]``, the expert MLPs as batched GEMMs, then the gather
and the gate-weighted scatter-add combine.  Capacity counts the step's
``T = B * S`` rows, padding rows included, as the reference does.

Every op is capturable in a CUDA graph: the per-expert counts are a
``scatter_add_`` into a length-E tensor (``torch.bincount`` reads its
maximum back to the host), and nothing reads a value on the host.  Top-k
breaks ties toward the lower expert index, as ``jax.lax.top_k`` does.  The
accumulating scatters are order-free: a buffer slot takes one assignment
and exact zeros from the clipped ones, a token at most k gated rows.

Expert weights are float masters ``[E, K, N]``, fake-quantized per output
channel under ``fake_quant``, or pre-packed int4 dicts (``{"packed" [E, K,
N/2], "scale" [E, 1, N]}``, per output channel, never a K-major twin) that
dequantize as ``(unpack_int4(packed).float() * scale).to(dtype)``.  The
dequantize and the GEMMs run `EXPERT_CHUNK` experts at a time, so a
full-width expert stack never exists as one float temporary; each
expert's arithmetic is the same at any chunk size.  When the step routes
fewer assignments (T * k) than there are experts, only the T * k most-used
experts run (every expert with a token is among them): the others would
map an all-zero buffer to zeros that no token gathers, so the output is
the same, and a decode step dequantizes a few experts instead of all of
them.

Under a mesh whose ``model`` size divides the experts (the JAX package's
``shard_map`` path) each rank holds E / tp experts (``e_start = rank *
n_local``) and its data slice of the tokens.  Expert weights sharded on
``data`` along their gatherable axis (the rules' FSDP placement) are
gathered over ``data`` inside the block, cast to bf16 first under a bf16
compute dtype; the gather's backward is the matching reduce-scatter.  The
router is made whole, each rank combines its own experts' outputs and the
partial outputs are summed over ``model``; the aux loss is the rank's data
shard's estimator, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.quant import fake_quant, unpack_int4
from ..core.quant_plan import join_site
from ..distributed.sharding import (TP, current_mesh, gather_for_compute,
                                    local_width, tp_copy_in, tp_gather,
                                    tp_rank, tp_reduce)
from .common import gelu_tanh, normal_init, silu

#: experts dequantized and multiplied at a time (one full-width expert
#: stack is 17.8 GB in float32 for arctic-480b, 21.5 GB for llama4)
EXPERT_CHUNK = 16


def init_moe(gen: torch.Generator, cfg,
             pack_expert: Optional[Callable] = None) -> Dict:
    """The router ``[D, E]``, then each expert stack ``[E, K, N]`` drawn one
    expert at a time (``w_in``, ``w_out``, then ``w_gate`` for SwiGLU).

    `pack_expert(name, (E, K, N))`, when given, returns None to keep that
    stack's float masters, or ``(put, packed)``: ``put(e, w)`` packs expert
    e's [K, N] master into ``packed``, the stack's serving dict.  A build
    then never holds more than one expert's master of a packed stack."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert or cfg.d_ff
    stacks = [("w_in", (D, F), D), ("w_out", (F, D), F)]
    if cfg.ffn_type == "swiglu":
        stacks.append(("w_gate", (D, F), D))
    p = {"router": {"w": normal_init(gen, (D, E))}, "experts": {}}
    for name, shape, fan in stacks:
        target = pack_expert(name, (E,) + shape) if pack_expert else None
        if target is None:
            stack = torch.empty((E,) + shape, device=gen.device)
            for e in range(E):
                stack[e] = normal_init(gen, shape, fan_in=fan)
            p["experts"][name] = stack
        else:
            put, p["experts"][name] = target
            for e in range(E):
                put(e, normal_init(gen, shape, fan_in=fan))
    return p


def _capacity(n_tokens: int, cfg) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def _dense(w, ids: torch.Tensor, qc, dtype) -> torch.Tensor:
    """Experts `ids` of one stack as [len(ids), K, N] weights in `dtype`.
    A packed stack dequantizes in one elementwise kernel: an int8 times a
    float32 tensor computes the float32 product of the converted value,
    and an output of `dtype` rounds it on the store, so the result is
    ``(q.float() * scale).to(dtype)`` without the float32 temporary."""
    if isinstance(w, dict):                     # packed int4 serving weights
        q = unpack_int4(w["packed"][ids], axis=-1)
        return torch.mul(q, w["scale"][ids].to(torch.float32),
                         out=torch.empty(q.shape, dtype=dtype,
                                         device=q.device))
    w = w[ids]
    if qc.backend == "fake_quant":
        # per-output-channel fake-quant along each expert's reduction dim
        w = fake_quant(w, axis=1, bits=qc.w_bits)
    return w.to(dtype)


def _expert_ffn(buf: torch.Tensor, experts: Dict, cfg, rt, site: str = "moe",
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """buf [El, C, D] -> [El, C, D] through the (quantized) expert MLPs.
    All expert weights share one plan site (``<site>.experts``): they run
    as batched GEMMs, so per-expert backends are not addressable.

    `live` (expert ids, a fixed count) names every expert that holds a
    token; only those run, and the others' rows are zeros, which is what
    their MLP makes of an all-zero buffer (and no token gathers them)."""
    qc = rt.quant_cfg(cfg, join_site(site, "experts"))
    ids = live if live is not None else torch.arange(buf.shape[0],
                                                      device=buf.device)
    out = torch.zeros_like(buf) if live is not None else torch.empty_like(buf)
    for c0 in range(0, ids.shape[0], EXPERT_CHUNK):
        part = ids[c0:c0 + EXPERT_CHUNK]
        b = buf[part]
        h = torch.bmm(b, _dense(experts["w_in"], part, qc, buf.dtype))
        if "w_gate" in experts:
            g = torch.bmm(b, _dense(experts["w_gate"], part, qc, buf.dtype))
            h = silu(g) * h
        else:
            h = gelu_tanh(h)
        out[part] = torch.bmm(h, _dense(experts["w_out"], part, qc,
                                        buf.dtype))
    return out


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest, ties toward the
    lower index (a stable descending sort keeps equal values in index
    order)."""
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gate[..., :k], idx[..., :k]


def _moe_shard(xf: torch.Tensor, router_w: torch.Tensor, experts: Dict, *,
               e_start: int, n_local: int, cfg, rt, site: str = "moe",
               dispatch: Optional[Dict] = None, reduce: bool = False):
    """Dispatch, compute and combine for `n_local` experts starting at
    `e_start`.  xf [T, D].  Returns (y [T, D], per-token aux [T]).  A
    `dispatch` dict, when given, receives the routing (``idx`` [T, k],
    ``order``, ``rank``, ``local`` [T*k]) for tests.  `reduce`: the ranks
    of ``model`` hold the other experts, so the output is their sum, and
    the gates and the dispatched rows, which only this rank's experts
    read, pass their partial gradients to the replicated router and input
    through ``tp_copy_in``."""
    T, D = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)

    logits = xf.to(torch.float32) @ router_w.to(torch.float32)   # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(tp_copy_in(probs) if reduce else probs, k)  # [T, k]
    if k > 1:
        gate = gate / (torch.sum(gate, dim=-1, keepdim=True) + 1e-9)

    flat_e = idx.reshape(-1)                                     # [T*k]
    flat_g = gate.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(E, dtype=torch.int64, device=xf.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))      # [E]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=xf.device) - starts[sorted_e]
    tok = order // k

    local = (sorted_e >= e_start) & (sorted_e < e_start + n_local) \
        & (rank < C)
    slot_e = torch.clamp(sorted_e - e_start, 0, n_local - 1)
    slot_c = torch.clamp(rank, 0, C - 1)
    w = local.to(xf.dtype)

    buf = torch.zeros((n_local, C, D), dtype=xf.dtype, device=xf.device)
    xd = tp_copy_in(xf) if reduce else xf
    buf.index_put_((slot_e, slot_c), w[:, None] * xd[tok], accumulate=True)

    # at most T * k experts hold a token: run those alone (a decode step
    # touches a few of them), picked as the fixed count T * k of most-used
    # experts, so the step's shapes do not depend on the routing
    live = None
    if T * k < n_local:
        used = counts[e_start:e_start + n_local]
        live = torch.sort(used, descending=True, stable=True).indices[:T * k]
    out_buf = _expert_ffn(buf, experts, cfg, rt, site=site,
                          live=live)                             # [El, C, D]

    gathered = out_buf[slot_e, slot_c]                           # [T*k, D]
    gw = torch.where(local, flat_g[order], torch.zeros_like(flat_g))
    contrib = gathered * gw.to(xf.dtype)[:, None]
    y = torch.zeros((T, D), dtype=xf.dtype, device=xf.device)
    y.index_add_(0, tok, contrib)
    if reduce:
        y = tp_reduce(y)

    # Switch-style load-balance aux: E * sum_e(frac_tokens_e * mean_prob_e)
    frac = counts.to(torch.float32) / (T * k)
    mean_p = torch.mean(probs, dim=0)
    aux = cfg.n_experts * torch.sum(frac * mean_p)
    if dispatch is not None:
        dispatch.update(idx=idx, order=order, rank=rank, local=local)
    return y, aux.expand(T)


def apply_moe(params: Dict, x: torch.Tensor, cfg, rt,
              site: str = "moe") -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux scalar): every expert on this
    device, or under a mesh whose ``model`` size divides the experts, this
    rank's E / tp of them (`_moe_mesh`)."""
    B, S, D = x.shape
    mesh = current_mesh()
    xf = x.reshape(B * S, D)
    if mesh is not None and cfg.n_experts % mesh.shape[TP] == 0:
        y, aux_t = _moe_mesh(params, xf, cfg, rt, site, mesh)
    else:
        y, aux_t = _moe_shard(xf, params["router"]["w"], params["experts"],
                              e_start=0, n_local=cfg.n_experts, cfg=cfg,
                              rt=rt, site=site)
    return y.reshape(B, S, D), torch.mean(aux_t)


def _data_axis(name: str, leaf: str, cfg) -> Tuple[int, int]:
    """(the axis of a stack's leaf that the rules shard on ``data``, its
    whole size): F of w_in / w_gate (their nibble pairs: F / 2) and of
    w_out; w_out's per-channel scale [E, 1, D] has none."""
    F = cfg.d_ff_expert or cfg.d_ff
    if name == "w_out":
        return 1, (1 if leaf == "scale" else F)
    return 2, (F // 2 if leaf == "packed" else F)


def _moe_mesh(params: Dict, xf: torch.Tensor, cfg, rt, site: str, mesh):
    """The expert-parallel block (the JAX package's ``shard_map`` body)."""
    n_local = cfg.n_experts // mesh.shape[TP]
    dp = mesh.shape["data"]
    router = params["router"]["w"]
    if local_width(router) != cfg.n_experts:
        router = tp_gather(router, -1)

    def gather(name, leaf, w):
        if (rt.compute_dtype == "bfloat16" and w.dtype == torch.float32
                and w.dim() == 3 and w.shape[-2] > 1):
            w = w.to(torch.bfloat16)     # not the quant scales [E, 1, *]
        ax, whole = _data_axis(name, leaf, cfg)
        if dp > 1 and w.shape[ax] * dp == whole:
            w = gather_for_compute(w, ax, "data")
        return w

    experts = {}
    for name, w in params["experts"].items():
        experts[name] = ({kk: gather(name, kk, ww) for kk, ww in w.items()}
                         if isinstance(w, dict) else gather(name, None, w))
    return _moe_shard(xf, router, experts, e_start=tp_rank() * n_local,
                      n_local=n_local, cfg=cfg, rt=rt, site=site,
                      reduce=True)
