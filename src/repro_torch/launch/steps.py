"""Serving step functions for the continuous-batching engine (PyTorch port
of ``repro/launch/steps.py::make_serving_steps``, paged layout).

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

from ..models.transformer import decode_step, prefill
from ..serving.kv_pages import with_block_tables


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
