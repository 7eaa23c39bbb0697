"""Serving step functions for the continuous-batching engine (PyTorch port
of ``repro/launch/steps.py``: ``make_serving_steps`` and
``make_ragged_step``, paged layout).

Each step gathers the batch's block-table rows on the device
(``tbl_all[slots]``), binds them to every layer, runs the model and takes
the greedy argmax on the device, so the only device->host traffic per step
is the engine's readback of one int32 per row.  Where the JAX package
donates the KV pool through a jit, these steps update the pool in place
(``serving.kv_pages.paged_write``) and return the same cache tree.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.transformer import _logits, decode_step, forward, prefill
from ..serving.kv_pages import with_block_tables, with_token_slots


def make_serving_steps(cfg, rt):
    """(prefill, tail_prefill, decode) steps, each
    ``step(params, tokens, caches, positions, tbl_all, slots)
    -> (next_tokens [B] int32, caches)``.

    ``tbl_all`` [max_batch, pages_per_seq] is the engine's device-resident
    table pool and ``slots`` [B] the batch rows' slots.  The tail-prefill
    step runs prefill with ``rt.prefill_over_cache``: the suffix queries of
    a prefix-cache hit attend over the gathered page pool."""
    vocab = cfg.vocab
    rt_tail = dataclasses.replace(rt, prefill_over_cache=True)

    def greedy(logits):
        return torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)

    def make_prefill(rt_used):
        @torch.inference_mode()
        def prefill_step(params, tokens, caches, positions, tbl_all, slots):
            caches = with_block_tables(caches,
                                       tbl_all.index_select(0, slots.long()))
            logits, caches = prefill(params, tokens, cfg, rt_used, caches,
                                     positions)
            return greedy(logits), caches

        return prefill_step

    @torch.inference_mode()
    def dec_step(params, token, caches, positions, tbl_all, slots):
        caches = with_block_tables(caches,
                                   tbl_all.index_select(0, slots.long()))
        logits, caches = decode_step(params, token, cfg, rt, caches,
                                     positions)
        return greedy(logits), caches

    return make_prefill(rt), make_prefill(rt_tail), dec_step


def make_ragged_step(cfg, rt):
    """The ragged token-major step:
    ``step(params, tokens, caches, positions, tbl_all, slots, emit_rows)
    -> (next_tokens [max_batch] int32, caches)``.

    tokens / positions [1, T] are a flat pack of prefill-chunk and decode
    rows, ``slots`` [T] each row's table row (-1 = padding).  ``emit_rows``
    [max_batch] names, per slot, the packed row whose logits give that
    request's next token (-1 = no emission this step: its prefill has
    chunks to go, or the slot is empty); the tied logits run only on those
    rows, and their greedy argmax stays on the device (-1 where nothing is
    emitted)."""
    vocab = cfg.vocab

    @torch.inference_mode()
    def ragged_step(params, tokens, caches, positions, tbl_all, slots,
                    emit_rows):
        caches = with_token_slots(caches, tbl_all, slots)
        hidden, caches = forward(params, tokens, cfg, rt, positions, caches,
                                 update_cache=True, return_hidden=True)
        h = hidden.index_select(1, emit_rows.clamp(min=0).long())  # [1,mb,D]
        logits = _logits(params, h, cfg, rt)[0]                    # [mb, Vp]
        nxt = torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)
        return torch.where(emit_rows >= 0, nxt, -1), caches

    return ragged_step
