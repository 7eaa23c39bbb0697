"""Decoder LM assembly: embedding -> repeat units of blocks -> tail blocks
-> norm -> logits (PyTorch port of ``repro/models/transformer.py``).

`cfg.pattern` is one repeat unit of block types ("A" attention + FFN, "M"
Mamba-2), repeated ``cfg.n_repeats`` times, then ``cfg.tail``.
Parameters keep the JAX package's tree: ``params["layers"]["u<j>"]`` holds
every leaf of the unit's j-th block stacked over the repeats on axis 0, and
``params["tail<t>"]`` the tail blocks, so weights carried across with
``convert.params_from_jax`` and the plan packer's size rule (counted over
the stacked leaf) agree with the reference.  Where the JAX package scans
over the repeats, `forward` loops over blocks in Python on per-block views
(`layer_params`); a quant plan that packs layers differently leaves
``params["layers"]`` a list of per-block trees (block ``r * P + j`` at
index ``r * P + j``), which the loop walks the same way.

Caches mirror the parameters: ``{"rep": {"u<j>": {kind: {...}}}, "tail":
{"tail<t>": {kind: {...}}}}`` with every rep leaf stacked over the repeats
(kind ``"attn"`` or ``"mamba"``).  Paged KV pools (a cache holding
``"tbl"``) are updated in place; contiguous caches and Mamba states are
written functionally, as the JAX package writes them, and `forward`
returns the new tree.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core.qlinear import qdense
from ..core.quant_plan import layer_slice
from .attention import apply_attention, init_attention, init_attn_cache
from .common import normal_init, rms_norm, sinusoidal_pos_embed
from .ffn import apply_ffn, init_ffn
from .ssm import apply_mamba, init_mamba, init_mamba_cache

#: the cache key of each ported block type
CACHE_KIND = {"A": "attn", "M": "mamba"}
#: the routing leaves a step binds into paged caches (not stacked per layer)
ROUTING = ("tbl", "slots")


def _check_supported(cfg) -> None:
    if cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks are not ported yet (ROADMAP Queue 1 "
            "item 10, after RG-LRU and the attention configs)")
    blocks = tuple(cfg.pattern) + tuple(cfg.tail)
    if "R" in blocks:
        raise NotImplementedError(
            f"{cfg.name}: RG-LRU blocks are not ported yet (the next slice: "
            "RG-LRU with recurrentgemma-9b)")
    unknown = sorted(set(blocks) - set(CACHE_KIND))
    if unknown:
        raise NotImplementedError(
            f"{cfg.name}: block types {unknown} are not ported")


# ----------------------------------------------------------------- blocks --
def init_block(gen: torch.Generator, block_type: str, cfg) -> Dict:
    D, dev = cfg.d_model, gen.device
    p: Dict = {"norm1": torch.ones((D,), device=dev)}
    if block_type == "A":
        p["attn"] = init_attention(gen, cfg)
        if cfg.d_ff:
            p["norm2"] = torch.ones((D,), device=dev)
            p["ffn"] = init_ffn(gen, cfg)
    elif block_type == "M":
        p["mamba"] = init_mamba(gen, cfg)
    else:
        raise ValueError(block_type)
    return p


def init_block_cache(block_type: str, cfg, rt, batch: int, seq: int,
                     device="cuda") -> Dict:
    """One block's contiguous cache: the attention ring or the Mamba
    state."""
    if block_type == "A":
        return {"attn": init_attn_cache(cfg, rt, batch, seq, device)}
    if block_type == "M":
        return {"mamba": init_mamba_cache(cfg, batch, device)}
    raise ValueError(block_type)


def apply_block(block_type: str, p: Dict, x, cfg, rt, positions,
                cache=None, update_cache: bool = False, site: str = ""):
    """One block; `site` (e.g. "block[3]") prefixes the sub-layers' plan
    sites.  "A": attention, then the FFN when ``d_ff``; "M": Mamba-2 (no
    FFN).  Returns (x, the block's new cache or None)."""
    normed = rms_norm(x, p["norm1"], cfg.norm_eps)
    kind = CACHE_KIND[block_type]
    sub = cache.get(kind) if cache else None
    if block_type == "A":
        h, nc = apply_attention(p["attn"], normed, cfg, rt, positions, sub,
                                update_cache, site=site)
        x = x + h
        if cfg.d_ff:
            x = x + apply_ffn(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps),
                              cfg, rt, site=f"{site}.ffn" if site else "ffn")
    else:
        h, nc = apply_mamba(p["mamba"], normed, cfg, rt, sub, update_cache,
                            site=f"{site}.mamba" if site else "mamba")
        x = x + h
    return x, ({kind: nc} if nc is not None else None)


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
    units = [[init_block(gen, bt, cfg) for bt in cfg.pattern]
             for _ in range(cfg.n_repeats)]
    params["layers"] = {f"u{j}": _stack([u[j] for u in units])
                        for j in range(len(cfg.pattern))}
    for t, bt in enumerate(cfg.tail):
        params[f"tail{t}"] = init_block(gen, bt, cfg)
    return params


def init_caches(cfg, rt, batch: int, seq: int, device="cuda") -> Dict:
    """The whole model's contiguous caches (`seq` = max context) on
    `device` (the card unless the caller asks for the CPU), each rep leaf
    stacked over the repeats (batch at dim 1), tail leaves per block
    (batch at dim 0)."""
    _check_supported(cfg)
    rep = {f"u{j}": _stack([init_block_cache(bt, cfg, rt, batch, seq, device)
                            for _ in range(cfg.n_repeats)])
           for j, bt in enumerate(cfg.pattern)}
    tail = {f"tail{t}": init_block_cache(bt, cfg, rt, batch, seq, device)
            for t, bt in enumerate(cfg.tail)}
    return {"rep": rep, "tail": tail}


def layer_params(params: Dict, cfg) -> List[Dict]:
    """Per-block views of the stacked repeat-unit parameters (block
    ``r * P + j`` at index ``r * P + j``), or the per-block trees of a plan
    that packs layers differently (``plan_pack_tree``)."""
    if isinstance(params["layers"], list):
        return params["layers"]
    P = len(cfg.pattern)
    return [layer_slice(params["layers"][f"u{j}"], r)
            for r in range(cfg.n_repeats) for j in range(P)]


def with_layer_views(params: Dict, cfg) -> Dict:
    """`params` plus its per-block views under ``"layer_views"``, so a
    serving loop slices the stacked weights once instead of every step."""
    return {**params, "layer_views": layer_params(params, cfg)}


def _layer_cache(unit_cache: Dict, r: int) -> Dict:
    """Repeat r's view of a unit block's stacked cache; paged routing
    leaves are shared by every layer."""
    return {kind: {key: val if key in ROUTING else val[r]
                   for key, val in c.items()}
            for kind, c in unit_cache.items()}


def _paged(block_cache: Dict) -> bool:
    return any("tbl" in c for c in block_cache.values())


def forward(params: Dict, tokens: torch.Tensor, cfg, rt,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Dict] = None, update_cache: bool = False,
            return_hidden: bool = False):
    """tokens [B, S] -> (logits_or_hidden, caches).  Paged pools (with
    bound block tables, ``serving.kv_pages``) are updated in place and
    returned; contiguous caches come back as a new tree (a block whose cache
    did not change keeps its old one)."""
    _check_supported(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).repeat(B, 1)
    dt = torch.bfloat16 if rt.compute_dtype == "bfloat16" else torch.float32
    x = params["embed"]["tok"][tokens.long()].to(dt)
    if cfg.rope == "none":
        x = x + sinusoidal_pos_embed(positions, cfg.d_model).to(dt)
    layers = params.get("layer_views") or layer_params(params, cfg)
    P = len(cfg.pattern)
    new_rep: Dict[str, List] = {f"u{j}": [] for j in range(P)}
    for i, lp in enumerate(layers):
        r, j = divmod(i, P)
        cache = (_layer_cache(caches["rep"][f"u{j}"], r)
                 if caches is not None else None)
        x, nc = apply_block(cfg.pattern[j], lp, x, cfg, rt, positions, cache,
                            update_cache, site=f"block[{i}]")
        new_rep[f"u{j}"].append(nc if nc is not None else cache)
    new_caches = None
    if caches is not None:
        new_caches = {"rep": {}, "tail": {}}
        for j in range(P):
            unit = caches["rep"][f"u{j}"]
            # paged pools were written in place: keep the stacked tree (its
            # routing leaves included); contiguous caches restack
            new_caches["rep"][f"u{j}"] = (unit if _paged(unit)
                                          else _stack(new_rep[f"u{j}"]))
    for t, bt in enumerate(cfg.tail):
        tc = caches["tail"][f"tail{t}"] if caches is not None else None
        x, nc = apply_block(bt, params[f"tail{t}"], x, cfg, rt, positions,
                            tc, update_cache,
                            site=f"block[{cfg.n_repeats * P + t}]")
        if new_caches is not None:
            new_caches["tail"][f"tail{t}"] = (tc if nc is None or _paged(tc)
                                              else nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, new_caches
    return _logits(params, x, cfg, rt), new_caches


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
