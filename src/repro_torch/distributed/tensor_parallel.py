"""Tensor-parallel layers over the ``model`` axis: column- and row-parallel
projections, the vocabulary-parallel embedding and cross-entropy.  Each is
the plain single-device computation without a mesh or at tp 1.

Whether a weight is sharded is read from its local shape against the
global width the caller states (the rules shard a dimension only where it
divides, ``distributed.sharding.param_spec``).

  * column-parallel (``wq/wk/wv``, ``ffn/w_in|w_gate``, ``lm_head``,
    ``mamba/in_proj``, ``lru/w_a|w_x``): the replicated input enters
    through `tp_copy_in`, each rank computes its N / tp columns.  Exact as
    it stands for every backend: each column's weight quantize and each
    row's activation quantize see the whole K.
  * row-parallel (``wo``, ``ffn/w_out``, ``mamba/out_proj``): the input is
    sharded along K and the partial products are summed over ``model``.
    Float GEMMs sum float32 partial products and round the sum once to the
    activation dtype.  A W4A4 GEMM on packed weights
    (``w4a4_packed`` and the other W4A4 backends, ``lut4`` included)
    quantizes each row with the global amax (an all-reduce max), runs the
    plan's kernel with unit scales, which returns the exact integer
    partial sums as f32 (|acc| <= 64 K < 2^24), sums them over ``model``
    and only then applies ``(acc * a_scale) * w_scale``: the single-device
    GEMM's result bit for bit.  ``fake_quant`` (the trainer's QAT backend)
    fake-quantizes each rank's rows with the whole K's scales (the weight's
    column amax and the activations' row amax max-reduced) and sums the
    partials as the float GEMM does.  The other backends that
    reduce a scale over K from a float master (``int_sim``, ``lut4``,
    ``w4a16``, ``netlist``) and packed weight-only weights gather the input
    and the weight's rows and compute the whole GEMM on every rank: the
    single-device numerics, at an all-gather of the weight a call.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.qlinear import W4A4_BACKENDS, qdense
from ..core.quant import dequantize, quant_scale, quantize
from .sharding import (local_rows, local_width, tp_copy_in, tp_gather,
                       tp_max, tp_rank, tp_reduce, tp_size, tp_slice)


def column_dense(w, x: torch.Tensor, qc, bias=None, tag: str = "", *,
                 n_out: int) -> Tuple[torch.Tensor, bool]:
    """x [..., K] replicated -> (y, sharded): this rank's columns of the
    [..., n_out] product when the weight is column-sharded, else the whole
    product."""
    if tp_size() > 1 and local_width(w) != n_out:
        if bias is not None and bias.shape[-1] == n_out:
            bias = tp_slice(bias, -1)      # a replicated bias's columns
        return qdense(w, tp_copy_in(x), qc, bias, tag=tag), True
    return qdense(w, x, qc, bias, tag=tag), False


def row_dense(w, x: torch.Tensor, qc, bias=None, tag: str = "", *,
              k_in: int, x_sharded: bool = False) -> torch.Tensor:
    """x [..., K] (this rank's K slice when `x_sharded`, else whole) ->
    y [..., N] replicated over ``model``; `bias` is added once, after the
    sum."""
    if tp_size() <= 1 or local_rows(w) == k_in:
        if x_sharded:
            x = tp_gather(x, -1)
        return qdense(w, x, qc, bias, tag=tag)
    if not x_sharded:
        x = tp_slice(x, -1)
    packed = isinstance(w, dict) and "packed" in w
    if packed and qc.backend in W4A4_BACKENDS and qc.a_bits == 4:
        # qdense's order: the f32 product, the bias, then the cast
        lead = x.shape[:-1]
        y = w4a4_row_parallel(x.reshape(-1, x.shape[-1]), w,
                              lut=qc.backend == "lut4")
        y = y.reshape(*lead, y.shape[-1])
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y.to(x.dtype)
    if qc.backend in ("float", "fake_quant") and not packed:
        y = tp_reduce(float_rows(w, x, qc)).to(x.dtype)
        return y if bias is None else (y + bias.to(y.dtype)).to(x.dtype)
    return qdense(_gather_rows(w), tp_gather(x, -1), qc, bias, tag=tag)


def _fake_quant_global(t: torch.Tensor, axis: int, bits: int):
    """``core.quant.fake_quant`` of this rank's slice of a tensor sharded
    along `axis` over ``model``, with the whole tensor's scales (the
    local amax max-reduced)."""
    t32 = t.to(torch.float32)
    amax = tp_max(t32.abs().amax(dim=axis, keepdim=True))
    scale = quant_scale(amax, axis=axis, bits=bits)
    tq = dequantize(quantize(t32, scale, bits=bits), scale).to(t.dtype)
    return t + (tq - t).detach()


def float_rows(w: torch.Tensor, x: torch.Tensor, qc) -> torch.Tensor:
    """The ``float`` or ``fake_quant`` GEMM's partial product [..., N], in
    float32, of this rank's K slice x [..., K_local] and K rows of w.  The
    operands are those of the single-device GEMM: in the activation dtype,
    and under ``fake_quant`` quantized with the whole K's scales (the
    weight's per column, the activations' per row; the gradient is the
    straight-through one).  The products are exact in float32, so the sum
    over ``model``, rounded once to the activation dtype, differs from the
    single-device GEMM (which rounds its float32 accumulator once) only by
    the order of the float32 sum."""
    if qc.backend == "fake_quant":
        w = _fake_quant_global(w, 0, qc.w_bits)
        x = _fake_quant_global(x, -1, qc.a_bits)
    f32 = torch.float32
    return torch.matmul(x.to(f32), w.to(x.dtype).to(f32))


def _gather_rows(w):
    """A row-sharded weight made whole: a float master's K rows, or a
    packed weight's nibble rows and, when grouped, its scale groups."""
    if not isinstance(w, dict):
        return tp_gather(w, -2)
    grouped = w["scale"].dim() == w["packed"].dim() + 1
    return {"packed": tp_gather(w["packed"], -2),
            "scale": tp_gather(w["scale"], -3) if grouped else w["scale"]}


# ------------------------------------------------ row-parallel W4A4 --------
def w4a4_row_partial(a_q: torch.Tensor, w_kmajor: torch.Tensor,
                     lut: bool = False) -> torch.Tensor:
    """The exact integer partial sums [M, N] of int4 activations a_q
    [M, K_local] against this rank's planar K-major rows, as f32: the
    plan's kernel (the unfused W4A4 GEMM, or the table-lookup one) with
    unit scales."""
    from ..kernels import ops

    M, N = a_q.shape[0], w_kmajor.shape[1]
    ones_a = torch.ones((M, 1), dtype=torch.float32, device=a_q.device)
    ones_w = torch.ones((1, N), dtype=torch.float32, device=a_q.device)
    gemm = ops.lut4_matmul_kmajor if lut else ops.int4_matmul_kmajor
    return gemm(a_q.contiguous(), ones_a, w_kmajor, ones_w)


def w4a4_row_epilogue(acc: torch.Tensor, a_scale: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """``(acc * a_scale) * w_scale``, the kernels' epilogue, in f32."""
    return acc * a_scale * w_scale


def w4a4_row_parallel(x2: torch.Tensor, w, lut: bool = False, *,
                      reduce_max=tp_max, reduce_sum=tp_reduce):
    """Row-parallel W4A4 GEMM of x2 [M, K_local] (this rank's K slice)
    against this rank's rows of a packed weight: global-amax quantize,
    integer partials summed over ``model``, then the scales.  The two
    collectives are `reduce_max` (of the rows' local amax [M, 1]) and
    `reduce_sum` (of the integer partials [M, N]); a caller that runs the
    ranks' bodies some other way passes its own."""
    from ..kernels.packing import nmajor_to_kmajor_grouped

    w_scale = w["scale"].to(torch.float32)
    w_km = w.get("packed_km")
    if w_km is None:
        w_km = nmajor_to_kmajor_grouped(w["packed"], w_scale).contiguous()
    xf = x2.to(torch.float32)
    # the whole row's scale: the local amax max-reduced, then quant_scale
    amax = reduce_max(xf.abs().amax(dim=1, keepdim=True))
    a_scale = quant_scale(amax, axis=1, bits=4)
    a_q = quantize(xf, a_scale, bits=4)
    acc = reduce_sum(w4a4_row_partial(a_q, w_km, lut))
    return w4a4_row_epilogue(acc, a_scale, w_scale)


# ------------------------------------------- vocabulary-parallel ends ------
def vocab_embed(tok: torch.Tensor, tokens: torch.Tensor,
                vocab_padded: int) -> Tuple[torch.Tensor, bool]:
    """(embeddings [B, S, D] in the table's dtype, partial): the whole
    table's lookup, or, when the table's rows are sharded over ``model``,
    this rank's rows' lookups with every other token's row zero (partial
    sums whose sum over ``model`` is the lookup: one non-zero term,
    exact)."""
    if tp_size() <= 1 or tok.shape[0] == vocab_padded:
        return tok[tokens.long()], False
    rows = tok.shape[0]
    ids = tokens.long() - tp_rank() * rows
    inside = (ids >= 0) & (ids < rows)
    x = tok[ids.clamp(0, rows - 1)]
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return x, True


def vocab_xent(logits: torch.Tensor, targets: torch.Tensor, vocab: int,
               v0: int = 0, sharded: bool = False) -> torch.Tensor:
    """Per-row cross-entropy [n] of float32 logits [n, V_local] (columns
    v0 .. v0 + V_local of the padded vocabulary) against targets [n]:
    columns past `vocab` masked to -1e30, the log-sum-exp and the target's
    logit reduced over ``model`` when the columns are `sharded`."""
    Vl = logits.shape[-1]
    cols = torch.arange(v0, v0 + Vl, device=logits.device)
    if v0 + Vl > vocab:
        logits = torch.where((cols < vocab)[None, :], logits,
                             torch.full((), -1e30, device=logits.device))
    if not sharded:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, 1, targets.long()[:, None])[:, 0]
        return lse - picked
    m = tp_max(logits.amax(dim=-1))
    lse = torch.log(tp_reduce(torch.exp(logits - m[:, None]).sum(-1))) + m
    t = targets.long() - v0
    inside = (t >= 0) & (t < Vl)
    picked = torch.gather(logits, 1, t.clamp(0, Vl - 1)[:, None])[:, 0]
    picked = tp_reduce(torch.where(inside, picked, torch.zeros_like(picked)))
    return lse - picked


def gather_columns(y: torch.Tensor, sharded: bool) -> torch.Tensor:
    """The whole last dim of a column-parallel output."""
    return tp_gather(y, -1) if sharded else y

