"""GQA attention with RoPE over the quantized linear (PyTorch port of
``repro/models/attention.py``, paged-KV serving branches).

Three interchangeable attention cores:

  * ``full``    -- materialized scores over the whole key range
  * ``chunked`` -- the same math one query chunk at a time (exact softmax)
  * ``flash``   -- the tiled online-softmax kernel
                   (``kernels.ops.flash_prefill``: the CUDA kernel on CUDA
                   tensors, its plain version on CPU tensors)

Masks come from explicit absolute positions (``-1`` = padding), which makes
causal, window and validity masking uniform across prefill and decode.
Two KV cache layouts, as in the JAX package: the paged pool
(``serving.kv_pages``: a dict holding ``"tbl"``, updated in place) and the
contiguous ring cache (`init_attn_cache`: one row of ``min(seq, window)``
slots per batch row with an absolute-position tensor ``kpos``, -1 = empty;
written functionally, as the JAX package writes it).  Both hold bf16/f32
K/V, or int8/int4 K/V quantized by `quantize_kv` with per-(token, head)
scales.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..core.qlinear import qdense
from ..core.quant_plan import join_site
from .common import apply_rope, normal_init

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg) -> Dict:
    hd, H, KV, D = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    if cfg.qk_norm:
        raise NotImplementedError("qk_norm attention is not ported yet")
    p = {
        "wq": normal_init(gen, (D, H * hd)),
        "wk": normal_init(gen, (D, KV * hd)),
        "wv": normal_init(gen, (D, KV * hd)),
        "wo": normal_init(gen, (H * hd, D), fan_in=H * hd),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["wq_bias"] = torch.zeros((H * hd,), device=dev)
        p["wk_bias"] = torch.zeros((KV * hd,), device=dev)
        p["wv_bias"] = torch.zeros((KV * hd,), device=dev)
    return p


def quantize_kv(val: torch.Tensor, int4: bool):
    """Per-(token, head) absmax quantization of K/V slabs [..., hd]: int8
    values (int4: nibble pairs packed along hd, element 2i in the low
    nibble) and f32 scales [..., 1].  The op sequence is the JAX package's,
    dtype by dtype: the scale, the division and the rounding run in `val`'s
    own dtype (bf16 on the serving path) and only the scale is cast to
    f32, so the bytes are the reference's.  The divisor is a tensor on
    `val`'s device, so CUDA divides as the CPU does (``core.quant.
    quant_scale``)."""
    qmax = 7.0 if int4 else 127.0
    amax = val.abs().amax(dim=-1, keepdim=True)
    scale = amax / amax.new_full((), qmax) + 1e-8
    q = torch.clamp(torch.round(val / scale), -qmax, qmax).to(torch.int8)
    if int4:
        from ..core.quant import pack_int4

        q = pack_int4(q, axis=-1)
    return q, scale.to(torch.float32)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_kv` (uint8 => packed nibbles): ``(q.f32 *
    scale) -> bf16``."""
    if q.dtype == torch.uint8:
        from ..core.quant import unpack_int4

        q = unpack_int4(q, axis=-1)
    return (q.to(torch.float32) * scale).to(torch.bfloat16)


# ------------------------------------------------ contiguous KV cache ------
def init_attn_cache(cfg, rt, batch: int, seq: int, device="cuda") -> Dict:
    """One attention layer's contiguous cache: a ring of ``min(seq,
    local_window)`` slots per row (`seq` = max context), ``pos`` [B] (the
    tokens the row has taken) and ``kpos`` [B, size] (each slot's absolute
    position, -1 = empty), with bf16/f32 K/V, or int8 K/V / int4 nibble
    pairs and f32 scales per (token, head)."""
    size = min(seq, cfg.local_window) if cfg.local_window else seq
    kv, hd = cfg.n_kv_heads, cfg.hd
    cache = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "kpos": torch.full((batch, size), -1, dtype=torch.int32,
                           device=device),
    }
    if rt.cache_dtype in ("int8", "int4"):
        int4 = rt.cache_dtype == "int4"
        shape = (batch, size, kv, hd // 2 if int4 else hd)
        dt = torch.uint8 if int4 else torch.int8
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=dt, device=device)
            cache[name + "_scale"] = torch.zeros(
                (batch, size, kv, 1), dtype=torch.float32, device=device)
    else:
        dt = torch.bfloat16 if rt.cache_dtype == "bfloat16" else torch.float32
        for name in ("k", "v"):
            cache[name] = torch.zeros((batch, size, kv, hd), dtype=dt,
                                      device=device)
    return cache


def _scatter_time(buf: torch.Tensor, val: torch.Tensor,
                  slots: torch.Tensor) -> torch.Tensor:
    """A new ``buf`` [B, size, ...] with ``val`` [B, n, ...] at slot indices
    ``slots`` [B, n].  Slot ``size`` is the drop sentinel (padding and
    invalid positions): the write goes to one extra slot past the ring,
    which the result leaves out (the JAX package's ``mode="drop"``)."""
    B, size = buf.shape[:2]
    out = buf.new_zeros((B, size + 1) + tuple(buf.shape[2:]))
    out[:, :size] = buf
    bidx = torch.arange(B, device=buf.device)[:, None].expand_as(slots)
    out[bidx, slots.long()] = val.to(buf.dtype)
    return out[:, :size]


def _cache_write(cache: Dict, k, v, abs_pos) -> Dict:
    """Write k/v [B, n, KV, hd] whose absolute positions are abs_pos [B, n]
    into a new contiguous cache: slot ``pos % size`` (the ring), negative
    positions to the drop sentinel.  Quantized caches store `quantize_kv`'s
    bytes and scales.  The JAX package's scatter path (``aligned=False``,
    the serving path)."""
    size = cache["k"].shape[1]
    slots = torch.where(abs_pos >= 0, abs_pos % size, size)
    out = dict(cache)
    if "k_scale" in cache:
        int4 = cache["k"].dtype == torch.uint8       # packed-nibble cache
        for name, val in (("k", k), ("v", v)):
            q, scale = quantize_kv(val, int4)
            out[name] = _scatter_time(cache[name], q, slots)
            out[name + "_scale"] = _scatter_time(cache[name + "_scale"],
                                                 scale, slots)
    else:
        out["k"] = _scatter_time(cache["k"], k, slots)
        out["v"] = _scatter_time(cache["v"], v, slots)
    out["kpos"] = _scatter_time(cache["kpos"], abs_pos, slots)
    return out


def _cache_read(cache: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache's K/V [B, size, KV, hd] (dequantized to bf16 when
    quantized)."""
    if "k_scale" in cache:
        return (dequantize_kv(cache["k"], cache["k_scale"]),
                dequantize_kv(cache["v"], cache["v_scale"]))
    return cache["k"], cache["v"]


def _gqa_block(q, k, v, mask):
    """q [B, n, KV, G, hd]; k/v [B, Skv, KV, hd]; mask [B, n, Skv] bool.
    Mixed operand dtypes (f32 queries over a dequantized bf16 pool) promote
    as jnp.einsum does."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    dt = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bqkgh,btkh->bkgqt", q.to(dt), k.to(dt)).to(
        torch.float32) * scale
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqt,btkh->bqkgh", probs.to(v.dtype), v)


def attention_core(q, k, v, *, q_positions, k_positions, window: int,
                   impl: str, chunk_q: int) -> torch.Tensor:
    """q [B, Sq, H, hd]; k/v [B, Skv, KV, hd]; positions [B, Sq] / [B, Skv]."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if impl == "flash":
        from ..kernels import ops

        return ops.flash_prefill(q, k, v, q_positions, k_positions,
                                 window=window)
    qg = q.reshape(B, Sq, KV, H // KV, hd)

    def mask3(qpos):                                  # [B, n, Skv]
        m = (qpos[:, :, None] >= k_positions[:, None, :]) \
            & (k_positions[:, None, :] >= 0)
        if window:
            m &= (qpos[:, :, None] - k_positions[:, None, :]) < window
        return m

    if impl == "full" or Sq <= chunk_q:
        return _gqa_block(qg, k, v, mask3(q_positions)).reshape(B, Sq, H, hd)
    outs = [_gqa_block(qg[:, i:i + chunk_q], k, v,
                       mask3(q_positions[:, i:i + chunk_q]))
            for i in range(0, Sq, chunk_q)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def apply_attention(params: Dict, x: torch.Tensor, cfg, rt,
                    positions: torch.Tensor, cache: Optional[Dict] = None,
                    update_cache: bool = False, site: str = ""
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B, S, D], positions [B, S].  The branches are those of the JAX
    package.  With a paged cache (a dict holding ``"tbl"``):  A cache that also
    holds ``"slots"`` is the ragged token-major step (B == 1, S packed rows,
    each routed through the table row ``slots`` names): write every row's
    K/V first, then attend with ``pos <= token_pos``, which is causal for
    prefill-chunk rows and last-token for decode rows.  S == 1 is decode
    (write the token's K/V, then the fused paged kernel, or the gather
    baseline with ``rt.paged_attn == "gather"``); ``rt.prefill_over_cache``
    is the tail prefill after a prefix-cache hit (write, then attend over
    the gathered pages); otherwise a fresh prefill attends in flight and
    writes its K/V.  The page pool is updated in place.  With a contiguous
    cache: S == 1 is decode (write the token into the ring, then exact
    attention over the cache, ``impl="full"``); otherwise the prompt
    attends in flight and, with `update_cache`, its last ``min(S, size)``
    positions are written, those below the row's ``pos`` (already cached:
    a resume) dropped.  The contiguous cache returned is a new dict of new
    tensors."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.rope != "rope":
        raise NotImplementedError(f"rope={cfg.rope!r} is not ported yet")

    qkv_site = join_site(site, "attn.qkv")
    wo_site = join_site(site, "attn.wo")
    qc = rt.quant_cfg(cfg, qkv_site)
    q = qdense(params["wq"], x, qc, params.get("wq_bias"), tag=qkv_site)
    k = qdense(params["wk"], x, qc, params.get("wk_bias"), tag=qkv_site)
    v = qdense(params["wv"], x, qc, params.get("wv_bias"), tag=qkv_site)
    q = apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, KV, hd)

    new_cache = None
    if cache is not None and "slots" in cache:
        from ..kernels import ops
        from ..serving.kv_pages import ragged_paged_write

        new_cache = ragged_paged_write(cache, k, v, positions)
        out = ops.ragged_paged_attention(
            q[0], new_cache["k"], new_cache["v"], new_cache["tbl"],
            cache["slots"], positions[0], new_cache.get("k_scale"),
            new_cache.get("v_scale"), window=cfg.local_window)[None]
    elif cache is not None and "tbl" in cache:
        from ..serving.kv_pages import paged_read, paged_write

        if S == 1:
            new_cache = paged_write(cache, k, v, positions)
            if rt.paged_attn == "fused":
                from ..kernels import ops

                out = ops.paged_decode_attention(
                    q[:, 0], new_cache["k"], new_cache["v"],
                    new_cache["tbl"], positions[:, -1],
                    new_cache.get("k_scale"), new_cache.get("v_scale"),
                    window=cfg.local_window)[:, None]
            else:
                kf, vf, kpos = paged_read(new_cache, positions[:, -1])
                out = attention_core(q, kf, vf, q_positions=positions,
                                     k_positions=kpos,
                                     window=cfg.local_window, impl="full",
                                     chunk_q=rt.attn_chunk_q)
        elif rt.prefill_over_cache:
            new_cache = paged_write(cache, k, v, positions) if update_cache \
                else cache
            kf, vf, kpos = paged_read(new_cache, positions[:, -1])
            out = attention_core(q, kf, vf, q_positions=positions,
                                 k_positions=kpos, window=cfg.local_window,
                                 impl=rt.attn_impl, chunk_q=rt.attn_chunk_q)
        else:
            out = attention_core(q, k, v, q_positions=positions,
                                 k_positions=positions,
                                 window=cfg.local_window, impl=rt.attn_impl,
                                 chunk_q=rt.attn_chunk_q)
            if update_cache:
                new_cache = paged_write(cache, k, v, positions)
    elif cache is not None and S == 1:
        new_cache = _cache_write(cache, k, v, positions)
        new_cache["pos"] = cache["pos"] + 1
        kf, vf = _cache_read(new_cache)
        out = attention_core(q, kf, vf, q_positions=positions,
                             k_positions=new_cache["kpos"],
                             window=cfg.local_window, impl="full",
                             chunk_q=rt.attn_chunk_q)
    else:
        out = attention_core(q, k, v, q_positions=positions,
                             k_positions=positions, window=cfg.local_window,
                             impl=rt.attn_impl, chunk_q=rt.attn_chunk_q)
        if update_cache and cache is not None:
            # the prompt's last min(S, size) positions, those the row has
            # already cached (a resume re-presenting them) dropped
            take = min(S, cache["k"].shape[1])
            wpos = positions[:, -take:]
            wpos = torch.where(wpos >= cache["pos"][:, None], wpos, -1)
            new_cache = _cache_write(cache, k[:, -take:], v[:, -take:], wpos)
            new_cache["pos"] = cache["pos"] + S

    out = out.reshape(B, S, H * hd)
    y = qdense(params["wo"], out, rt.quant_cfg(cfg, wo_site), tag=wo_site)
    return y, new_cache
