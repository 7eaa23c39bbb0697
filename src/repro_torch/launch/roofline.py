"""Roofline terms of a dry-run cell, with NVIDIA H100 SXM constants
(PyTorch port of ``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds, per device:

    compute    = FLOPs / peak (PEAK_FLOPS_INT8 for the int8 fraction,
                 PEAK_FLOPS_BF16 for the rest)
    memory     = bytes_accessed / HBM_BW
    collective = collective_operand_bytes / NVLINK_BW

`model_params`, `model_flops`, `roofline_terms` and `CollectiveStats` keep
the JAX module's arithmetic unchanged; only the constants differ.

Where the inputs come from (``launch.dryrun``): the FLOPs are
``torch.utils.flop_counter.FlopCounterMode``'s count of the step's matmuls
and attention products at full depth, the W4A4 kernels' share of them the
int8 fraction; the bytes accessed are those of the ops the step launches:
a kernel's operands and result at their stored size, every other op's
operands and result as eager PyTorch runs it, unfused; the collective
bytes are the operands of the collectives the port's code calls
(``distributed.sharding.COLLECTIVES``, the ledger), one entry a call.
The JAX module's ``parse_collectives`` reads them from the post-SPMD HLO
text; the port has no HLO (its collectives are explicit calls, not
inserted by a partitioner), so that parser has no input here and is left
out.

The collective term times every byte at NVLink 4's rate.  On an H100 SXM
node eight GPUs share one NVLink domain; the production mesh's 16-wide
``model`` axis spans two such nodes, whose links between them (InfiniBand,
~50 GB/s a GPU) are far slower, so for that mesh the term is a lower bound
and not an estimate.  Cross-pod bytes (a collective over a group that
holds the ``pod`` axis) are reported, not timed, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# ----------------------------------------------------- hardware constants --
# NVIDIA H100 SXM5 (80 GB HBM3), dense (no structured sparsity), from the
# NVIDIA H100 Tensor Core GPU datasheet; the same three PERF.md's kernel
# bounds use.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, BF16 tensor cores, dense
PEAK_FLOPS_INT8 = 1979e12       # OP/s, INT8 tensor cores, dense
HBM_BW = 3.35e12                # B/s, HBM3
# NVLink 4: 18 links of 50 GB/s (25 GB/s each way), 900 GB/s a GPU in both
# directions together (the datasheet's "NVLink: 900GB/s"): the aggregate,
# so the collective term is a lower bound (the JAX constant is one ICI
# link's rate).
NVLINK_BW = 900e9               # B/s a GPU


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    cross_pod_bytes: float
    count: int

    def total(self) -> float:
        return sum(self.bytes_by_kind.values())


# ---------------------------------------------------------- model flops ----
def model_params(cfg) -> Tuple[int, int]:
    """(total params N, active-per-token params N_active), analytic."""
    D, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_padded

    def attn_p():
        return D * cfg.n_heads * cfg.hd * 2 + D * cfg.n_kv_heads * cfg.hd * 2

    def ffn_p(F):
        mult = 3 if cfg.ffn_type == "swiglu" else 2
        return mult * D * F

    total = active = 0
    counts = {"A": 0, "M": 0, "R": 0}
    pattern_full = list(cfg.pattern) * cfg.n_repeats + list(cfg.tail)
    for bt in pattern_full:
        counts[bt] += 1
    for bt, n in counts.items():
        if n == 0:
            continue
        if bt == "A":
            per = attn_p()
            per_active = per
            if cfg.n_experts:
                e = ffn_p(cfg.d_ff_expert or cfg.d_ff)
                per += cfg.n_experts * e + D * cfg.n_experts
                per_active += cfg.top_k * e
                if cfg.shared_expert:
                    per += e
                    per_active += e
                if cfg.moe_dense_ff:
                    de = ffn_p(cfg.moe_dense_ff)
                    per += de
                    per_active += de
            elif cfg.d_ff:
                per += ffn_p(cfg.d_ff)
                per_active = per
        elif bt == "M":
            di, N, H, G = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                           cfg.ssm_groups)
            per = D * (2 * di + 2 * G * N + H) + di * D
            per_active = per
        else:  # R
            W = cfg.lru_width or D
            per = 2 * D * W + 2 * W * W + W * D
            per_active = per
            if cfg.d_ff:
                per += ffn_p(cfg.d_ff)
                per_active += ffn_p(cfg.d_ff)
        total += per * n
        active += per_active * n
    emb = V * D * (1 if cfg.tie_embeddings else 2)
    total += emb
    active += emb
    return int(total), int(active)


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the cell: 6*N*tokens (train, incl. bwd) or
    2*N_active*tokens (inference), plus causal-attention score FLOPs."""
    n_total, n_active = model_params(cfg)
    B, S = shape.batch, shape.seq
    n_attn_layers = sum(
        1 for bt in (list(cfg.pattern) * cfg.n_repeats + list(cfg.tail))
        if bt == "A"
    )
    if shape.kind == "train":
        tokens = B * S
        gemm = 6 * n_active * tokens
        ctx = min(S, cfg.local_window) if cfg.local_window else S
        attn = (3 * 2 * 2 * B * S * ctx / 2 * cfg.n_heads * cfg.hd
                * n_attn_layers)
        return gemm + attn
    if shape.kind == "prefill":
        tokens = B * S
        gemm = 2 * n_active * tokens
        ctx = min(S, cfg.local_window) if cfg.local_window else S
        attn = 2 * 2 * B * S * ctx / 2 * cfg.n_heads * cfg.hd * n_attn_layers
        return gemm + attn
    # decode: one token against a cache of length S
    tokens = B
    gemm = 2 * n_active * tokens
    ctx = min(S, cfg.local_window) if cfg.local_window else S
    attn = 2 * 2 * B * ctx * cfg.n_heads * cfg.hd * n_attn_layers
    return gemm + attn


# ------------------------------------------------------------------ terms --
def roofline_terms(
    flops_per_dev: float,
    bytes_per_dev: float,
    coll_bytes_per_dev: float,
    *,
    int8_fraction: float = 0.0,
) -> Dict[str, float]:
    peak = (PEAK_FLOPS_BF16 * (1 - int8_fraction)
            + PEAK_FLOPS_INT8 * int8_fraction)
    t_c = flops_per_dev / peak
    t_m = bytes_per_dev / HBM_BW
    t_x = coll_bytes_per_dev / NVLINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "bound": dom,
        "step_s_lower_bound": max(t_c, t_m, t_x),
    }
