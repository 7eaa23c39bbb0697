"""GQA attention with RoPE, M-RoPE or no rotation (sinusoidal stacks) and
optional qk-norm over the quantized linear (PyTorch port of
``repro/models/attention.py``, paged-KV serving branches).

Three interchangeable attention cores:

  * ``full``    -- materialized scores over the whole key range
  * ``chunked`` -- the same math one query chunk at a time (exact softmax)
  * ``flash``   -- the tiled online-softmax kernel
                   (``kernels.ops.flash_prefill``: the CUDA kernel on CUDA
                   tensors, its plain version on CPU tensors)

Masks come from explicit absolute positions (``-1`` = padding), which makes
causal, window and validity masking uniform across prefill and decode.
Under a mesh (``distributed.sharding``) the projections are tensor
parallel: ``wq/wk/wv`` by columns, ``wo`` by rows, where the rules shard
them.  K and V are gathered whole after their projections, so every cache
holds every KV head on every rank; the core then uses the ``model`` axis
by `_attn_strategy`, as the JAX package does: "head" (KV heads divide tp,
or, with Megatron-style KV-head duplication, the query heads do), "seq"
(the query positions divide tp: each rank attends its slice of the
queries over all keys) or "none" (replicated).  Flash prefill runs on
each rank's operands in that layout (its heads, or its query positions);
the fused paged decode and the ragged kernel run on every query head,
gathered, on every rank.

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

from ..core.quant_plan import join_site
from ..distributed.sharding import (tp_copy_in, tp_gather, tp_rank, tp_size,
                                    tp_slice)
from ..distributed.tensor_parallel import (column_dense, gather_columns,
                                           row_dense)
from .common import apply_mrope, apply_rope, normal_init, rms_norm

NEG_INF = -1e30


def _attn_strategy(n_units: int, seq: int) -> str:
    """How the core uses the ``model`` axis: "head" where the units (KV
    heads, or query heads after duplication) divide tp, "seq" where the
    query positions do, else "none" (decode, tiny shapes)."""
    tp = tp_size()
    if tp <= 1:
        return "none"
    if n_units % tp == 0:
        return "head"
    if seq > 1 and seq % tp == 0:
        return "seq"
    return "none"


def _constrain(t: torch.Tensor, strategy: str, *, role: str,
               n_heads: int = 0) -> torch.Tensor:
    """The core's operand `t` in `strategy`'s layout (the JAX package's
    four constraint sites in ``_gqa_block``): ``role`` "q" ([B, S, H, hd],
    whole or this rank's heads), "kv" ([B, Skv, KV, hd], whole) or "out"
    (the core's output)."""
    if tp_size() <= 1:
        return t
    if role == "q":
        if strategy == "head":
            return t if t.shape[2] != n_heads else tp_slice(t, 2)
        t = t if t.shape[2] == n_heads else tp_gather(t, 2)
        return tp_slice(t, 1) if strategy == "seq" else t
    if role == "kv":
        if strategy == "head":
            return tp_slice(t, 2)
        # seq-sharded queries attend over every key: partial gradients
        return tp_copy_in(t) if strategy == "seq" else t
    return tp_gather(t, 1) if strategy == "seq" else t


def _tp_core(core, q, k, v, q_positions, strategy: str, n_heads: int):
    """`core(q, k, v, q_positions)` under `strategy`; returns (out, heads
    sharded).  At tp 1 it is `core` alone."""
    if tp_size() <= 1:
        return core(q, k, v, q_positions), False
    KV = k.shape[2]
    if strategy == "head" and KV % tp_size():
        # Megatron-style KV-head duplication: each query-head shard holds
        # copies of the KV heads it reads
        k = torch.repeat_interleave(k, n_heads // KV, dim=2)
        v = torch.repeat_interleave(v, n_heads // KV, dim=2)
    q = _constrain(q, strategy, role="q", n_heads=n_heads)
    k = _constrain(k, strategy, role="kv")
    v = _constrain(v, strategy, role="kv")
    qpos = q_positions
    if strategy == "seq":
        n = q.shape[1]
        qpos = q_positions.narrow(1, n * tp_rank(), n).contiguous()
    out = core(q, k, v, qpos)
    return _constrain(out, strategy, role="out"), strategy == "head"


def init_attention(gen: torch.Generator, cfg) -> Dict:
    hd, H, KV, D = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
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
    if cfg.qk_norm:
        # ones: nothing is drawn, so the other leaves keep their values
        p["q_norm"] = torch.ones((hd,), device=gen.device)
        p["k_norm"] = torch.ones((hd,), device=gen.device)
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
    """x [B, S, D], positions [B, S], or [3, B, S] (the M-RoPE streams; the
    temporal stream ``positions[0]`` then masks and addresses the caches).
    With ``cfg.qk_norm`` q and k are RMS-normed per head after the
    projections, before the rotation; with ``rope="none"`` they are not
    rotated (the stack adds sinusoidal positions to its embeddings). The
    branches are those of the JAX package. With a paged cache (a dict
    holding ``"tbl"``): A cache that also holds ``"slots"`` is the ragged
    token-major step (B == 1, S packed rows, each routed through the table
    row ``slots`` names): write every row's K/V first, then attend with
    ``pos <= token_pos``, which is causal for prefill-chunk rows and
    last-token for decode rows. S == 1 is decode (write the token's K/V,
    then the fused paged kernel, or the gather baseline with
    ``rt.paged_attn == "gather"``); ``rt.prefill_over_cache`` is the tail
    prefill after a prefix-cache hit (write, then attend over the gathered
    pages); otherwise a fresh prefill attends in flight and writes its K/V.
    The page pool is updated in place. With a contiguous cache: S == 1 is
    decode (write the token into the ring, then exact attention over the
    cache, ``impl="full"``); otherwise the prompt attends in flight and,
    with `update_cache`, its last ``min(S, size)`` positions are written,
    those below the row's ``pos`` (already cached: a resume) dropped. The
    contiguous cache returned is a new dict of new tensors."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    qkv_site = join_site(site, "attn.qkv")
    wo_site = join_site(site, "attn.wo")
    qc = rt.quant_cfg(cfg, qkv_site)
    q, q_sh = column_dense(params["wq"], x, qc, params.get("wq_bias"),
                           tag=qkv_site, n_out=H * hd)
    k, k_sh = column_dense(params["wk"], x, qc, params.get("wk_bias"),
                           tag=qkv_site, n_out=KV * hd)
    v, v_sh = column_dense(params["wv"], x, qc, params.get("wv_bias"),
                           tag=qkv_site, n_out=KV * hd)
    if q_sh and H % tp_size():
        q = tp_gather(q, -1)          # the shards cut a head: whole heads
    # every cache holds every KV head
    k, v = gather_columns(k, k_sh), gather_columns(v, v_sh)
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        # this rank's query heads give the shared weight partial gradients
        qn = params["q_norm"]
        q = rms_norm(q, qn if q.shape[2] == H else tp_copy_in(qn),
                     cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    tpos = positions if positions.dim() == 2 else positions[0]  # temporal
    if cfg.rope == "rope":
        q = apply_rope(q, tpos, cfg.rope_theta)
        k = apply_rope(k, tpos, cfg.rope_theta)
    elif cfg.rope == "mrope":
        mp = positions if positions.dim() == 3 else torch.stack([tpos] * 3)
        q = apply_mrope(q, mp, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, mp, cfg.rope_theta, cfg.mrope_sections)
    positions = tpos
    tp = tp_size()
    dup = tp > 1 and KV % tp != 0 and H % tp == 0
    strategy = _attn_strategy(H if dup else KV, S)

    def attend(kf, vf, k_positions, impl):
        def core(qq, kk, vv, qpos):
            return attention_core(qq, kk, vv, q_positions=qpos,
                                  k_positions=k_positions,
                                  window=cfg.local_window, impl=impl,
                                  chunk_q=rt.attn_chunk_q)
        return _tp_core(core, q, kf, vf, positions, strategy, H)

    new_cache = None
    heads_sh = False
    if cache is not None and "slots" in cache:
        from ..kernels import ops
        from ..serving.kv_pages import ragged_paged_write

        new_cache = ragged_paged_write(cache, k, v, positions)
        qr = q if q.shape[2] == H else tp_gather(q, 2)    # every head
        out = ops.ragged_paged_attention(
            qr[0], new_cache["k"], new_cache["v"], new_cache["tbl"],
            cache["slots"], positions[0], new_cache.get("k_scale"),
            new_cache.get("v_scale"), window=cfg.local_window)[None]
    elif cache is not None and "tbl" in cache:
        from ..serving.kv_pages import paged_read, paged_write

        if S == 1:
            new_cache = paged_write(cache, k, v, positions)
            if rt.paged_attn == "fused":
                from ..kernels import ops

                qd = q if q.shape[2] == H else tp_gather(q, 2)  # every head
                out = ops.paged_decode_attention(
                    qd[:, 0], new_cache["k"], new_cache["v"],
                    new_cache["tbl"], positions[:, -1],
                    new_cache.get("k_scale"), new_cache.get("v_scale"),
                    window=cfg.local_window)[:, None]
            else:
                # the gather baseline
                kf, vf, kpos = paged_read(new_cache, positions[:, -1])
                out, heads_sh = attend(kf, vf, kpos, "full")
        elif rt.prefill_over_cache:
            new_cache = paged_write(cache, k, v, positions) if update_cache \
                else cache
            kf, vf, kpos = paged_read(new_cache, positions[:, -1])
            out, heads_sh = attend(kf, vf, kpos, rt.attn_impl)
        else:
            out, heads_sh = attend(k, v, positions, rt.attn_impl)
            if update_cache:
                new_cache = paged_write(cache, k, v, positions)
    elif cache is not None and S == 1:
        new_cache = _cache_write(cache, k, v, positions)
        new_cache["pos"] = cache["pos"] + 1
        kf, vf = _cache_read(new_cache)
        out, heads_sh = attend(kf, vf, new_cache["kpos"], "full")
    else:
        out, heads_sh = attend(k, v, positions, rt.attn_impl)
        if update_cache and cache is not None:
            # the prompt's last min(S, size) positions, those the row has
            # already cached (a resume re-presenting them) dropped
            take = min(S, cache["k"].shape[1])
            wpos = positions[:, -take:]
            wpos = torch.where(wpos >= cache["pos"][:, None], wpos, -1)
            new_cache = _cache_write(cache, k[:, -take:], v[:, -take:], wpos)
            new_cache["pos"] = cache["pos"] + S

    out = out.reshape(B, S, -1)
    y = row_dense(params["wo"], out, rt.quant_cfg(cfg, wo_site), tag=wo_site,
                  k_in=H * hd, x_sharded=heads_sh)
    return y, new_cache
