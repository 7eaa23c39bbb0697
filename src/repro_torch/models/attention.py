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
The paged KV cache (``serving.kv_pages``, bf16/f32 pools or int8/int4 pools
quantized by `quantize_kv`) is the only cache layout ported; the
contiguous ring cache waits.
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
    f32, so the bytes are the reference's."""
    qmax = 7.0 if int4 else 127.0
    scale = val.abs().amax(dim=-1, keepdim=True) / qmax + 1e-8
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
    """x [B, S, D], positions [B, S].  With a paged cache (a dict holding
    ``"tbl"``) the branches are those of the JAX package.  A cache that also
    holds ``"slots"`` is the ragged token-major step (B == 1, S packed rows,
    each routed through the table row ``slots`` names): write every row's
    K/V first, then attend with ``pos <= token_pos``, which is causal for
    prefill-chunk rows and last-token for decode rows.  S == 1 is decode
    (write the token's K/V, then the fused paged kernel, or the gather
    baseline with ``rt.paged_attn == "gather"``); ``rt.prefill_over_cache``
    is the tail prefill after a prefix-cache hit (write, then attend over
    the gathered pages); otherwise a fresh prefill attends in flight and
    writes its K/V.  The page pool is updated in place."""
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
    elif cache is not None:
        raise NotImplementedError(
            "only the paged KV cache is ported; the contiguous cache waits")
    else:
        out = attention_core(q, k, v, q_positions=positions,
                             k_positions=positions, window=cfg.local_window,
                             impl=rt.attn_impl, chunk_q=rt.attn_chunk_q)

    out = out.reshape(B, S, H * hd)
    y = qdense(params["wo"], out, rt.quant_cfg(cfg, wo_site), tag=wo_site)
    return y, new_cache
