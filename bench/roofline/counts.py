"""The work each kernel of the served step has to do, counted from the
configuration's shapes and each call's real rows, and the least time the
chip could take for it.

Frozen with the benchmark: the counts are those of the algorithm, whatever
implements it.  Each input byte is read once and each output byte written
once; padding rows are no work.  Activations move in bfloat16, weights as
int4 codes with float32 per-channel scales, K/V in the configuration's
cache dtype.  A W4A4 projection's products run at the int8 rate, attention
and the float lm_head at the bfloat16 rate.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

PEAKS: Dict = json.loads(
    (Path(__file__).resolve().parent / "peaks.json").read_text())
ACT = 2          # bytes of a bfloat16 activation
KV_BYTES = {"bfloat16": 2, "float32": 4, "int8": 1, "int4": 0.5}


def projections(d: Dict) -> List[Tuple[int, int]]:
    """(K, N) of each W4A4 projection of one layer, in call order."""
    D, H, KV, hd, F = d["D"], d["H"], d["KV"], d["hd"], d["F"]
    out = [(D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D), (D, F)]
    if d["gated"]:
        out.append((D, F))
    return out + [(F, D)]


def w4a4_gemm(M: int, K: int, N: int) -> Tuple[float, float]:
    """(operations, bytes) of one W4A4 projection over M real rows."""
    return 2.0 * M * K * N, M * K * ACT + K * N / 2 + N * 4 + M * N * ACT


def layer_gemms(d: Dict, M: int) -> Tuple[float, float]:
    """The bound, in seconds, of one layer's projections at M rows, summed
    call by call, and the operations."""
    t, ops = 0.0, 0.0
    for K, N in projections(d):
        o, b = w4a4_gemm(M, K, N)
        t += bound_s(o, b, PEAKS["int8_op_per_s"])
        ops += o
    return t, ops


def paged_decode(d: Dict, rows: int, ctx_sum: int,
                 cache: str = "bfloat16") -> Tuple[float, float]:
    """(operations, bytes) of one layer's decode attention: `rows` queries,
    each over its own context, `ctx_sum` keys in all."""
    H, KV, hd = d["H"], d["KV"], d["hd"]
    ops = 4.0 * H * hd * ctx_sum
    byts = 2 * rows * H * hd * ACT + 2 * ctx_sum * KV * hd * KV_BYTES[cache]
    return ops, byts


def flash_prefill(d: Dict, n: int, past: int = 0) -> Tuple[float, float]:
    """(operations, bytes) of one layer's causal prefill of `n` new tokens
    after `past` cached ones: query i sees past + i + 1 keys."""
    H, KV, hd = d["H"], d["KV"], d["hd"]
    pairs = n * past + n * (n + 1) / 2
    ops = 4.0 * H * hd * pairs
    byts = (2 * n * H * hd + 2 * (past + n) * KV * hd) * ACT
    return ops, byts


def lm_head(d: Dict, M: int) -> Tuple[float, float]:
    D, V = d["D"], d["V"]
    return 2.0 * M * D * V, M * D * ACT + D * V * ACT + M * V * ACT


def bound_s(ops: float, byts: float, rate: float) -> float:
    """The least time: the larger of operations at `rate` and bytes at the
    memory's rate."""
    return max(ops / rate, byts / PEAKS["hbm_byte_per_s"])


def decode_step_at_peak(d: Dict, rows: int, ctx_sum: int) -> float:
    """Seconds one decode step's operations take at the peaks: every
    layer's projections (int8 rate) and attention (bf16), the lm_head
    (bf16)."""
    proj = sum(2.0 * K * N for K, N in projections(d)) * rows
    attn = 4.0 * d["H"] * d["hd"] * ctx_sum
    return d["L"] * (proj / PEAKS["int8_op_per_s"]
                     + attn / PEAKS["bf16_flop_per_s"]) \
        + lm_head(d, rows)[0] / PEAKS["bf16_flop_per_s"]


def prefill_at_peak(d: Dict, n: int, past: int = 0) -> float:
    """Seconds one prefill of `n` real tokens takes at the peaks (its
    logits: the last position's only)."""
    proj = sum(2.0 * K * N for K, N in projections(d)) * n
    attn = flash_prefill(d, n, past)[0]
    return d["L"] * (proj / PEAKS["int8_op_per_s"]
                     + attn / PEAKS["bf16_flop_per_s"]) \
        + lm_head(d, 1)[0] / PEAKS["bf16_flop_per_s"]
