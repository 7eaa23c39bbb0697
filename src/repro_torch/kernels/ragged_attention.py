"""Ragged token-major paged attention: the CUDA kernel
(``csrc/ragged_decode.cu``) and its plain PyTorch version.

Ports ``repro/kernels/ragged_attention.py``.  The ragged serving step packs
every live request's tokens, chunked-prefill slices and single decode
tokens alike, into one flat ``[T, ...]`` buffer and attends them all in one
launch.  Each packed row carries two scalars:

  ``token_slot[t]``  the block-table row of the request it belongs to
                     (-1 = padding row),
  ``token_pos[t]``   its absolute position in that request (-1 = padding).

The engine writes the step's K/V through the block tables before attending
(``serving.kv_pages.ragged_paged_write``), so the pool holds every position
``<= token_pos[t]`` for row ``t`` and the decode mask ``pos <= token_pos``
is causal for prefill-chunk rows and last-token for decode rows.  A padding
row outputs exact zeros.

The plain version is ``ragged_attention_xla``: gather each row's table row
(padding rows get an all-sentinel row) and run the plain paged decode
version with batch == tokens, so its decode rows are those of the bucketed
decode path.  The kernel shares the paged decode kernel's body
(``csrc/decode_common.cuh``) and its split of the table
(``paged_attention.decode_plan``), and agrees with the plain version to
bf16 tolerance.  ``kernels.ops`` picks the plain version for CPU tensors and the
kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .paged_attention import _check_cuda, check_pools, decode_plan_for, \
    paged_decode_attention_plain


def ragged_decode_attention_plain(q, k_pool, v_pool, tbl, token_slot,
                                  token_pos, k_scale=None, v_scale=None,
                                  window: int = 0, pp: int = 4
                                  ) -> torch.Tensor:
    """q [T, H, hd]; pools [P, ps, KV, hd(/2)] (+ f32 scales when
    quantized); tbl [max_batch, pps]; token_slot / token_pos [T].  A row
    whose slot is negative is a padding row whatever its position (the
    engine sets both to -1; the kernel zeroes either)."""
    P = k_pool.shape[0]
    maxB = tbl.shape[0]
    slot = token_slot.to(torch.int32)
    live = slot >= 0
    rows = tbl.to(torch.int32)[slot.clamp(0, maxB - 1).long()]
    tbl_pt = torch.where(live[:, None], rows, P)               # [T, pps]
    lp = torch.where(live, token_pos.to(torch.int32), -1)
    return paged_decode_attention_plain(q, k_pool, v_pool, tbl_pt, lp,
                                        k_scale, v_scale, window=window,
                                        pp=pp)


def _bind(lib: ctypes.CDLL) -> None:
    lib.ragged_decode_launch.argtypes = [ctypes.c_void_p] * 9 \
        + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.ragged_decode_launch.restype = ctypes.c_int


def ragged_decode_attention_cuda(q, k_pool, v_pool, tbl, token_slot,
                                 token_pos, k_scale=None, v_scale=None,
                                 window: int = 0) -> torch.Tensor:
    """Launch the ragged decode kernel: q [T, H, hd] bf16; pools as
    ``paged_attention.check_pools`` takes them; tbl [max_batch, pps],
    token_slot and token_pos [T], all int32."""
    name = "ragged_decode_attention_cuda"
    kind = check_pools(name, q, k_pool, v_pool, k_scale, v_scale)
    i32 = torch.int32
    _check_cuda(name, (q, tbl, token_slot, token_pos),
                (torch.bfloat16, i32, i32, i32))
    T, H, hd = q.shape
    P, ps, KV = k_pool.shape[:3]
    if (tbl.dim() != 2 or tbl.shape[0] < 1 or token_slot.shape != (T,)
            or token_pos.shape != (T,)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, tbl "
                         f"{tuple(tbl.shape)}, token_slot "
                         f"{tuple(token_slot.shape)}, token_pos "
                         f"{tuple(token_pos.shape)}")
    maxB, pps = tbl.shape
    out = torch.empty_like(q)
    if T == 0:
        return out
    plan = decode_plan_for(tbl, k_pool)
    lib = _build.load("ragged_decode", _bind)
    code = lib.ragged_decode_launch(
        _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
        _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(tbl),
        _build.ptr(token_slot), _build.ptr(token_pos), _build.ptr(out),
        T, H, KV, hd, P, ps, maxB, pps, int(window), kind,
        1.0 / math.sqrt(hd), plan.split_tok, plan.nsplit,
        _build.stream_of(q))
    _build.check(lib, code, "ragged_decode_attention")
    ragged_decode_attention_cuda.launches += 1
    return out


ragged_decode_attention_cuda.launches = 0
