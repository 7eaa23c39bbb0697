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
    partials as the float GEMM does.  The backends that quantize a float
    master per call follow the W4A4 pattern (`master_rows`): the weight's
    column amax and the activations' row amax are max-reduced, each rank
    quantizes its K rows with the global scales, and
      - ``int_sim`` / ``pallas_int4`` and ``lut4`` run the plan's kernel
        (the unfused W4A4 GEMM, or the table-lookup one) with unit scales;
        ``netlist`` sums its circuit's products over the local K; other
        widths sum ``int_mm_padded``'s int32 products: exact integer
        partials, summed, then scaled, bit for bit the single-device GEMM;
      - ``w4a16`` runs the W4A16 kernel on the local rows with the global
        scales (per channel; per group, a group split between ranks cut
        into sub-groups of ``gcd(K_local, G)`` rows, each with its group's
        scale) and sums the f32 partials: the single-device GEMM up to the
        order of the f32 sum.
    Packed weight-only weights (``w4a16_packed``, or packed under
    ``w4a16``) hold whole groups on each rank (the rules shard the nibbles
    and a grouped scale's groups together, ``sharding._check_packed``):
    each rank runs the W4A16 kernel on its rows and the f32 partials are
    summed.  A packed W4A4 weight at activation widths other than 4 sums
    ``int_mm_padded``'s partials after the global row scale.  Every
    packed weight goes through `packed_rows`.  So no row-parallel call
    gathers a weight, with one exception: a call on a float master being
    differentiated (the trainer under ``int_sim``, ``pallas_int4``,
    ``lut4`` or ``w4a16``, whose gradient reaches the weight and the
    activations through the scales' amax) gathers the input and the
    weight's rows and runs the single-device GEMM on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

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
    if qc.backend in ("float", "fake_quant") and not packed:
        y = tp_reduce(float_rows(w, x, qc)).to(x.dtype)
        return y if bias is None else (y + bias.to(y.dtype)).to(x.dtype)
    if not packed and torch.is_grad_enabled() and (x.requires_grad
                                                   or w.requires_grad):
        return qdense(tp_gather(w, -2), tp_gather(x, -1), qc, bias, tag=tag)
    # qdense's order: the f32 product, the bias, then the cast
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = (packed_rows if packed else master_rows)(w, x2, qc, tag)
    y = y.reshape(*lead, y.shape[-1])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(x.dtype)


#: backends whose GEMM from a float master is an integer one
INT_MASTER_BACKENDS = ("int_sim", "pallas_int4", "lut4", "netlist")


def _int_partial(a_q: torch.Tensor, w_q: torch.Tensor, qc,
                 tag: str = "") -> torch.Tensor:
    """The exact integer partial sums [M, N] of this rank's quantized K
    slices a_q [M, K_local] and w_q [K_local, N]: as f32 from the plan's
    kernel with unit scales at 4 bits (|acc| <= 64 K < 2^24), as int32
    from the circuit (``netlist``) or ``int_mm_padded`` (other widths)."""
    from ..core.backends import int_mm_padded
    from ..kernels.packing import pack_kmajor

    if qc.backend == "netlist":
        from ..core.mult4_proposed import build_proposed_mult4
        from ..core.qlinear import check_int4
        from ..core.quant import to_unsigned_mag

        check_int4(qc, tag)
        mag_a, sign_a = to_unsigned_mag(a_q)
        mag_w, sign_w = to_unsigned_mag(w_q)
        prod = build_proposed_mult4()(mag_a[:, :, None],
                                      mag_w[None, :, :]).to(torch.int32)
        prod = prod * sign_a[:, :, None] * sign_w[None, :, :]
        return prod.sum(dim=1, dtype=torch.int32)
    if qc.a_bits == 4 and qc.w_bits == 4:
        return w4a4_row_partial(a_q, pack_kmajor(w_q).contiguous(),
                                lut=qc.backend == "lut4")
    return int_mm_padded(a_q, w_q)


@dataclasses.dataclass(frozen=True)
class RowComm:
    """The ``model`` axis as a row-parallel body sees it: its max- and
    sum-reductions, this rank's index and the axis's size.  `mesh_comm` is
    the current mesh's; a caller that runs the ranks' bodies some other
    way (one thread a rank) builds its own."""
    reduce_max: Callable
    reduce_sum: Callable
    rank: int
    size: int


def mesh_comm() -> RowComm:
    return RowComm(tp_max, tp_reduce, tp_rank(), tp_size())


def _global_scale(t: torch.Tensor, dim: int, bits: int,
                  comm: RowComm) -> torch.Tensor:
    """``quant_scale`` over a dimension sharded over ``model``: the local
    amax max-reduced."""
    return quant_scale(comm.reduce_max(t.abs().amax(dim=dim, keepdim=True)),
                       axis=dim, bits=bits)


def master_rows(w: torch.Tensor, x2: torch.Tensor, qc, tag: str = "",
                comm: Optional[RowComm] = None) -> torch.Tensor:
    """Row-parallel GEMM of x2 [M, K_local] (this rank's K slice) against
    this rank's K rows of a float master, quantized per call, summed over
    ``model``: f32 [M, N], as ``core.backends``' single-device GEMM (see
    the module docstring)."""
    comm = comm or mesh_comm()
    if qc.backend in INT_MASTER_BACKENDS:
        xf = x2.to(torch.float32)
        w_scale = _global_scale(w, 0, qc.w_bits, comm)       # [1, N]
        w_q = quantize(w, w_scale, bits=qc.w_bits)
        a_scale = _global_scale(xf, 1, qc.a_bits, comm)      # [M, 1]
        a_q = quantize(xf, a_scale, bits=qc.a_bits)
        acc = comm.reduce_sum(_int_partial(a_q, w_q, qc, tag))
        return w4a4_row_epilogue(acc.to(torch.float32), a_scale, w_scale)
    if qc.backend == "w4a16":
        return comm.reduce_sum(_w4a16_master_partial(w, x2, qc, comm))
    raise ValueError(f"site {tag!r}: no row-parallel GEMM for backend "
                     f"{qc.backend!r} on a float master")


def _w4a16_master_partial(w: torch.Tensor, x2: torch.Tensor, qc,
                          comm: RowComm) -> torch.Tensor:
    """This rank's f32 partial [M, N] of the ``w4a16`` GEMM from a float
    master's K_local rows, quantized with the whole weight's scales: per
    channel (the column amax max-reduced), or per group of G rows, where
    each sub-group of ``gcd(K_local, G)`` rows takes its group's scale
    (the groups' amax max-reduced over ``model``).  Widths other than 4
    dequantize and multiply in f32, as ``core.backends`` does."""
    import math

    from ..core.quant import group_dequantize
    from ..kernels import ops
    from ..kernels.packing import pack_kmajor

    Kl, N = w.shape
    K = Kl * comm.size
    G = qc.group_size if qc.group_size else K
    if G >= K:
        scale = _global_scale(w, 0, qc.w_bits, comm)         # [1, N]
        w_q, g = quantize(w, scale, bits=qc.w_bits), Kl
    else:
        sub = math.gcd(Kl, G)
        amax = w.reshape(Kl // sub, sub, N).abs().amax(dim=1)  # [Kl/sub, N]
        # each sub-group's global group, then the groups' global amax
        grp = (comm.rank * Kl + torch.arange(0, Kl, sub,
                                             device=w.device)) // G
        gmax = amax.new_zeros((K // G, N)).scatter_reduce(
            0, grp[:, None].expand_as(amax), amax, "amax")
        gmax = comm.reduce_max(gmax)
        scale = quant_scale(gmax.index_select(0, grp)[:, None, :], axis=1,
                            bits=qc.w_bits)               # [Kl/sub, 1, N]
        w_q = quantize(w.reshape(Kl // sub, sub, N), scale,
                       bits=qc.w_bits).reshape(Kl, N)
        g = sub
    if qc.w_bits != 4:
        return torch.matmul(x2.to(torch.float32),
                            group_dequantize(w_q, scale, g))
    rm = 2 * g if scale.ndim == 3 else 2
    return ops.w4a16_matmul_kmajor(x2, pack_kmajor(w_q, rm), scale, g)


def packed_rows(w, x2: torch.Tensor, qc, tag: str = "",
                comm: Optional[RowComm] = None) -> torch.Tensor:
    """Row-parallel GEMM of x2 [M, K_local] against this rank's rows of a
    packed weight, summed over ``model``: f32 [M, N].  W4A4 backends at
    4-bit activations run `w4a4_row_parallel`; at other widths the integer
    partials of the unpacked rows are summed after the global row scale.
    The weight-only backends run the W4A16 kernel on the local rows (whole
    groups) and sum the f32 partials."""
    from ..core.qlinear import _packed_backend
    from ..core.quant import unpack_int4

    comm = comm or mesh_comm()
    if qc.backend in W4A4_BACKENDS:
        if qc.a_bits == 4:
            return w4a4_row_parallel(x2, w, lut=qc.backend == "lut4",
                                     comm=comm)
        xf = x2.to(torch.float32)
        w_scale = w["scale"].to(torch.float32)
        a_scale = _global_scale(xf, 1, qc.a_bits, comm)
        a_q = quantize(xf, a_scale, bits=qc.a_bits)
        acc = comm.reduce_sum(_int_partial(
            a_q, unpack_int4(w["packed"], axis=-1), qc, tag))
        return w4a4_row_epilogue(acc.to(torch.float32), a_scale, w_scale)
    return comm.reduce_sum(_packed_backend(w, x2, qc, tag))


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


def w4a4_row_parallel(x2: torch.Tensor, w, lut: bool = False,
                      comm: Optional[RowComm] = None):
    """Row-parallel W4A4 GEMM of x2 [M, K_local] (this rank's K slice)
    against this rank's rows of a packed weight: global-amax quantize,
    integer partials summed over ``model``, then the scales.  `comm`
    (default `mesh_comm`) max-reduces the rows' local amax [M, 1] and sums
    the integer partials [M, N]."""
    from ..kernels.packing import nmajor_to_kmajor_grouped

    comm = comm or mesh_comm()
    w_scale = w["scale"].to(torch.float32)
    w_km = w.get("packed_km")
    if w_km is None:
        w_km = nmajor_to_kmajor_grouped(w["packed"], w_scale).contiguous()
    xf = x2.to(torch.float32)
    # the whole row's scale: the local amax max-reduced, then quant_scale
    a_scale = _global_scale(xf, 1, 4, comm)
    a_q = quantize(xf, a_scale, bits=4)
    acc = comm.reduce_sum(w4a4_row_partial(a_q, w_km, lut))
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

