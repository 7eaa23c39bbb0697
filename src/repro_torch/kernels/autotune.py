"""Default tile heuristics (the untuned branch of
``repro/kernels/autotune.py``).

The plain versions of the attention kernels take their blocking from here,
exactly as the JAX package's XLA twins do on an untuned host: the decode
twin's pages per block is ``attn_default_blocks(...)["bk"] // page_size``
and the flash twin's kv tile is ``attn_default_blocks(...)["bk"]``.  Both
change the order of floating-point sums, so the port keeps them.  The GEMM
defaults (``default_blocks``) are not ported: the W4A4 plain version's
integer sums are exact in any order, so its tiling changes nothing.  The
timed search and its on-disk cache are not ported either.
"""

from __future__ import annotations

from typing import Dict

#: attention ops reuse the (bm, bn, bk) entry format: bk = kv tokens per
#: program (pages_per_program * page_size for the paged ops, with page
#: size in the group_size slot), bn = KV-head tile, bm = q tile
ATTN_OPS = ("attn.paged_decode", "attn.prefill", "attn.ragged")
_PAGED_ATTN_OPS = ("attn.paged_decode", "attn.ragged")


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def attn_default_blocks(op: str, M: int, K: int, N: int,
                        group_size: int = 0) -> Dict[str, int]:
    """Heuristic tiles for the attention ops (M = batch rows or q length,
    K = kv context length, N = H * hd)."""
    if op in _PAGED_ATTN_OPS:
        ps = max(1, group_size)
        target = 256 if ps < 8 else 512
        bk = max(ps, min(_round_up(K, ps), _round_up(target, ps)))
        return {"bm": 1, "bn": 0, "bk": bk}
    bq = 128 if M >= 128 else max(8, _round_up(M, 8))
    bk = 128 if K >= 128 else max(8, _round_up(K, 8))
    return {"bm": bq, "bn": 0, "bk": bk}
