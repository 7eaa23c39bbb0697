"""Public entry points for the kernels: device dispatch, tile lookup for the
plain versions, and launch counts.

Dispatch follows the tensor's device and nothing else: a CPU tensor runs
the kernel's plain PyTorch version, a CUDA tensor launches the hand-written
CUDA kernel (``csrc/``), which raises if it cannot take the input.  There
is no fallback from the kernel to the plain version and no switch that
sends CUDA tensors to it.

Each CUDA wrapper counts its own launches in a plain integer attribute
(``launch_counts()`` reads them, ``reset_launch_counts()`` zeroes them), so
a run can show that it went through the kernels.  A replayed CUDA graph
runs no wrapper: its launches are added by ``add_launch_counts``.

Each entry that launches a kernel passes its call through `COUNT_CALL`
when that is set: the dry-run (``launch.dryrun``) sets it to count the
kernel's operands and result at their stored size in place of the plain
version's unfused ops.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from . import autotune
from .int4_matmul import (int4_matmul_cuda, int4_matmul_fused_cuda,
                          int4_matmul_fused_plain, int4_matmul_plain)
from .lut4_matmul import lut4_matmul_cuda, lut4_matmul_plain
from .lut_mul4 import lut_mul4_cuda, lut_mul4_plain
from .packing import nmajor_to_kmajor
from .paged_attention import (
    flash_prefill_cuda,
    flash_prefill_plain,
    paged_decode_attention_cuda,
    paged_decode_attention_plain,
)
from .ragged_attention import (
    ragged_decode_attention_cuda,
    ragged_decode_attention_plain,
)
from .w4a16_matmul import w4a16_matmul_cuda, w4a16_matmul_plain

#: kernel name -> its CUDA wrapper (the holder of the launch count)
CUDA_WRAPPERS = {
    "int4_matmul_fused": int4_matmul_fused_cuda,
    "flash_prefill": flash_prefill_cuda,
    "paged_decode_attention": paged_decode_attention_cuda,
    "ragged_decode_attention": ragged_decode_attention_cuda,
    "int4_matmul": int4_matmul_cuda,
    "w4a16_matmul": w4a16_matmul_cuda,
    "lut4_matmul": lut4_matmul_cuda,
    "lut_mul4": lut_mul4_cuda,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in CUDA_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in CUDA_WRAPPERS.values():
        fn.launches = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add `counts` to the wrappers' launch counts: a replayed graph's
    launches, which no wrapper counted (``launch.steps.CapturedStep``)."""
    for name, n in counts.items():
        CUDA_WRAPPERS[name].launches += n


#: the dry-run's hook, else None: each entry below that launches a kernel
#: returns ``COUNT_CALL(name, call, args)`` in place of ``call()``, its own
#: body on its arguments `args`
COUNT_CALL = None


def _entry(name: str):
    """Pass the decorated entry of kernel `name` through COUNT_CALL."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if COUNT_CALL is None:
                return fn(*args, **kwargs)
            return COUNT_CALL(name, lambda: fn(*args, **kwargs), args)
        return entry
    return wrap


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel for device {t.device}")


@_entry("int4_matmul_fused")
def int4_matmul_fused_kmajor(x, w_kmajor, w_scale):
    """Fused activation-quantize W4A4 on planar K-major weights
    ([ceil(K/2), N] uint8): float x [M, K] in, f32 [M, N] out."""
    if _on_cuda(x, "int4_matmul_fused"):
        return int4_matmul_fused_cuda(x.to(torch.float32).contiguous(),
                                      w_kmajor, w_scale)
    return int4_matmul_fused_plain(x, w_kmajor, w_scale)


def int4_matmul(a_q, a_scale, w_packed, w_scale):
    """W4A4 GEMM on pre-quantized activations: a_q [M, K] int8, a_scale
    [M, 1] f32, the serialized interleaved weight [K, N/2] uint8
    (``core.quant.pack_int4``), w_scale [1, N] -> f32 [M, N]."""
    return int4_matmul_kmajor(a_q, a_scale,
                              nmajor_to_kmajor(w_packed).contiguous(),
                              w_scale)


@_entry("int4_matmul")
def int4_matmul_kmajor(a_q, a_scale, w_kmajor, w_scale):
    """W4A4 GEMM on pre-quantized activations and planar K-major weights
    ([ceil(K/2), N] uint8)."""
    if _on_cuda(a_q, "int4_matmul"):
        return int4_matmul_cuda(a_q, a_scale, w_kmajor, w_scale)
    return int4_matmul_plain(a_q, a_scale, w_kmajor, w_scale)


def lut4_matmul(a_q, a_scale, w_packed, w_scale):
    """Table-lookup W4A4 GEMM; operands as `int4_matmul` (serialized
    interleaved weight)."""
    return lut4_matmul_kmajor(a_q, a_scale,
                              nmajor_to_kmajor(w_packed).contiguous(),
                              w_scale)


@_entry("lut4_matmul")
def lut4_matmul_kmajor(a_q, a_scale, w_kmajor, w_scale):
    """Table-lookup W4A4 GEMM on planar K-major weights."""
    if _on_cuda(a_q, "lut4_matmul"):
        return lut4_matmul_cuda(a_q, a_scale, w_kmajor, w_scale)
    return lut4_matmul_plain(a_q, a_scale, w_kmajor, w_scale)


def w4a16_matmul(x, w_packed, w_scale, group_size: int):
    """Weight-only int4 GEMM: x [M, K] bf16/f32, the serialized interleaved
    weight [K, N/2], scales [1, N] or [K // G, 1, N] -> f32 [M, N].  Grouped
    weights are repacked with K padded to a multiple of 2G."""
    row_mult = 2 * group_size if w_scale.ndim == 3 else 2
    return w4a16_matmul_kmajor(
        x, nmajor_to_kmajor(w_packed, row_mult).contiguous(), w_scale,
        group_size)


@_entry("w4a16_matmul")
def w4a16_matmul_kmajor(x, w_kmajor, w_scale, group_size: int):
    """Weight-only int4 GEMM on planar K-major weights ([Kh, N] uint8)."""
    if _on_cuda(x, "w4a16_matmul"):
        return w4a16_matmul_cuda(x.contiguous(), w_kmajor,
                                 w_scale.contiguous(), group_size)
    return w4a16_matmul_plain(x, w_kmajor, w_scale, group_size)


@_entry("lut_mul4")
def mul4(a_q, b_q, strategy: str = "onehot"):
    """Elementwise exact int4 x int4 -> int8 product through the 256-entry
    product table; `strategy` ("onehot" | "take") names the JAX package's
    two lookups, which give the same integers."""
    if _on_cuda(a_q, "lut_mul4"):
        return lut_mul4_cuda(a_q, b_q, strategy)
    return lut_mul4_plain(a_q, b_q, strategy)


@_entry("paged_decode_attention")
def paged_decode_attention(q, k_pool, v_pool, tbl, last_pos, k_scale=None,
                           v_scale=None, *, window: int = 0):
    """Decode attention over the KV page pool: q [B, H, hd]; pools
    [P, ps, KV, hd(/2)] (+ f32 scales [P, ps, KV, 1] for int8/int4 pools);
    tbl [B, pages_per_seq]; last_pos [B] (-1 = inactive row, zero
    output)."""
    if _on_cuda(q, "paged_decode_attention"):
        return paged_decode_attention_cuda(q, k_pool, v_pool, tbl, last_pos,
                                           k_scale, v_scale, window=window)
    B, H, hd = q.shape
    ps = k_pool.shape[1]
    b = autotune.attn_default_blocks("attn.paged_decode", B,
                                     tbl.shape[1] * ps, H * hd, group_size=ps)
    return paged_decode_attention_plain(q, k_pool, v_pool, tbl, last_pos,
                                        k_scale, v_scale, window=window,
                                        pp=max(1, b["bk"] // ps))


@_entry("ragged_decode_attention")
def ragged_paged_attention(q, k_pool, v_pool, tbl, token_slot, token_pos,
                           k_scale=None, v_scale=None, *, window: int = 0):
    """Ragged token-major attention over the KV page pool, one launch for a
    flat pack of prefill-chunk and decode rows: q [T, H, hd]; pools as for
    `paged_decode_attention`; tbl [max_batch, pages_per_seq]; token_slot /
    token_pos [T] (-1 = padding row, zero output)."""
    if _on_cuda(q, "ragged_decode_attention"):
        return ragged_decode_attention_cuda(q, k_pool, v_pool, tbl,
                                            token_slot, token_pos, k_scale,
                                            v_scale, window=window)
    T, H, hd = q.shape
    ps = k_pool.shape[1]
    b = autotune.attn_default_blocks("attn.ragged", T, tbl.shape[1] * ps,
                                     H * hd, group_size=ps)
    return ragged_decode_attention_plain(q, k_pool, v_pool, tbl, token_slot,
                                         token_pos, k_scale, v_scale,
                                         window=window,
                                         pp=max(1, b["bk"] // ps))


@_entry("flash_prefill")
def flash_prefill(q, k, v, q_positions, k_positions, *, window: int = 0):
    """Tiled flash prefill with position masks: q [B, Sq, H, hd]; k/v
    [B, Skv, KV, hd]; positions [B, S] (-1 = padding)."""
    if _on_cuda(q, "flash_prefill"):
        return flash_prefill_cuda(q, k, v, q_positions, k_positions,
                                  window=window)
    B, Sq, H, hd = q.shape
    b = autotune.attn_default_blocks("attn.prefill", Sq, k.shape[1], H * hd)
    return flash_prefill_plain(q, k, v, q_positions, k_positions,
                               window=window, bk=b["bk"])
