"""Decoder LM assembly: embedding -> attention/FFN blocks -> norm -> tied
logits (PyTorch port of ``repro/models/transformer.py``, dense attention
stacks).

Parameters keep the JAX package's tree: ``params["layers"]["u0"]`` holds
every leaf of the repeated block stacked over layers on axis 0, so weights
carried across with ``convert.params_from_jax`` and the plan packer's size
rule (counted over the stacked leaf) agree with the reference.  Where the
JAX package scans over that axis, `forward` loops over layers in Python on
per-layer views (``layer_params``); a quant plan that packs layers
differently leaves ``params["layers"]`` a list of per-layer trees, which
the loop walks the same way.  Paged KV pools are stacked the same
way and updated in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core.qlinear import qdense
from ..core.quant_plan import layer_slice
from .attention import apply_attention, init_attention
from .common import normal_init, rms_norm
from .ffn import apply_ffn, init_ffn


def _check_supported(cfg) -> None:
    if tuple(cfg.pattern) != ("A",) or cfg.tail or cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: only dense attention stacks are ported "
            f"(pattern {cfg.pattern}, tail {cfg.tail}, family {cfg.family})")


# ----------------------------------------------------------------- blocks --
def init_block(gen: torch.Generator, cfg) -> Dict:
    D, dev = cfg.d_model, gen.device
    return {"norm1": torch.ones((D,), device=dev),
            "attn": init_attention(gen, cfg),
            "norm2": torch.ones((D,), device=dev),
            "ffn": init_ffn(gen, cfg)}


def apply_block(p: Dict, x, cfg, rt, positions, cache=None,
                update_cache: bool = False, site: str = ""):
    """One attention + FFN block; `site` (e.g. "block[3]") prefixes the
    sub-layers' plan sites.  Returns (x, cache)."""
    h, nc = apply_attention(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps),
                            cfg, rt, positions, cache, update_cache, site=site)
    x = x + h
    x = x + apply_ffn(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg,
                      rt, site=f"{site}.ffn" if site else "ffn")
    return x, nc


# ------------------------------------------------------------------ model --
def _stack(trees: List[Dict]) -> Dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_model(gen: torch.Generator, cfg) -> Dict:
    """Random f32 parameters on the generator's device."""
    _check_supported(cfg)
    Vp, D = cfg.vocab_padded, cfg.d_model
    params: Dict = {
        "embed": {"tok": normal_init(gen, (Vp, D), fan_in=D)},
        "final_norm": torch.ones((D,), device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal_init(gen, (D, Vp))}
    params["layers"] = {"u0": _stack([init_block(gen, cfg)
                                      for _ in range(cfg.n_repeats)])}
    return params


def layer_params(params: Dict, n_layers: int) -> List[Dict]:
    """Per-layer views of the stacked block parameters, or the per-layer
    trees of a plan that packs layers differently (``plan_pack_tree``)."""
    if isinstance(params["layers"], list):
        return params["layers"]
    return [layer_slice(params["layers"]["u0"], r) for r in range(n_layers)]


def with_layer_views(params: Dict, cfg) -> Dict:
    """`params` plus its per-layer views under ``"layer_views"``, so a
    serving loop slices the stacked weights once instead of every step."""
    return {**params, "layer_views": layer_params(params, cfg.n_layers)}


def forward(params: Dict, tokens: torch.Tensor, cfg, rt,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Dict] = None, update_cache: bool = False,
            return_hidden: bool = False):
    """tokens [B, S] -> (logits_or_hidden, caches).  `caches` are paged
    pools with bound block tables (``serving.kv_pages``), updated in place
    and returned."""
    _check_supported(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).repeat(B, 1)
    dt = torch.bfloat16 if rt.compute_dtype == "bfloat16" else torch.float32
    x = params["embed"]["tok"][tokens.long()].to(dt)
    layers = params.get("layer_views") or layer_params(params, cfg.n_layers)
    attn_c = caches["rep"]["u0"]["attn"] if caches is not None else None
    for r, lp in enumerate(layers):
        cache = None
        if attn_c is not None:
            # layer r's pools (and scale pools) under the shared routing
            # leaves: the block table, and the ragged step's token slots
            cache = {key: val if key in ("tbl", "slots") else val[r]
                     for key, val in attn_c.items()}
        x, _ = apply_block(lp, x, cfg, rt, positions, cache, update_cache,
                           site=f"block[{r}]")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, caches
    return _logits(params, x, cfg, rt), caches


def _logits(params, x, cfg, rt):
    """x [..., D] -> logits [..., Vp]: the tied embedding product in the
    activation dtype (a plain large matmul, as the JAX package leaves it to
    XLA), or the plan's lm_head site."""
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(x.dtype)                  # [Vp, D]
        return torch.matmul(x, w.t())
    return qdense(params["lm_head"]["w"], x, rt.quant_cfg(cfg, "lm_head"),
                  tag="lm_head")


# ------------------------------------------------------------ serve steps --
def prefill(params, tokens, cfg, rt, caches, positions=None):
    """Fill caches with a prompt; returns (last_logits [B, Vp], caches)."""
    hidden, caches = forward(params, tokens, cfg, rt, positions, caches,
                             update_cache=True, return_hidden=True)
    return _logits(params, hidden[:, -1:], cfg, rt)[:, 0], caches


def decode_step(params, token, cfg, rt, caches, positions):
    """One decode step. token [B, 1]; positions [B, 1] absolute positions."""
    hidden, caches = forward(params, token, cfg, rt, positions, caches,
                             update_cache=True, return_hidden=True)
    return _logits(params, hidden, cfg, rt)[:, 0], caches
