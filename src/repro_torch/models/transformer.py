"""Decoder LM assembly: embedding -> repeat units of blocks -> tail blocks
-> norm -> logits (PyTorch port of ``repro/models/transformer.py``).

`cfg.pattern` is one repeat unit of block types ("A" attention + FFN, "M"
Mamba-2, "R" RG-LRU + FFN), repeated ``cfg.n_repeats`` times, then
``cfg.tail`` (recurrentgemma: (R, R, A) x 12, then (R, R)).
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
(kind ``"attn"``, ``"mamba"`` or ``"lru"``).  Paged KV pools (a cache holding
``"tbl"``) are updated in place; contiguous caches and Mamba states are
written functionally, as the JAX package writes them, and `forward`
returns the new tree.

`init_model` draws block by block and writes each block into its stacked
leaf at once, so a build holds one copy of the repeat weights.  Given a
``core.quant_plan.LayerPacker`` it packs each block for the serving plan
as soon as it is drawn (the layer-at-a-time build of
``serving.engine.build_params``): the build then holds the packed stack
and one block's float masters, or for an expert stack one expert's, and
returns what ``pack_for_serving`` makes of the float tree.

Under a mesh (``distributed.sharding.mesh_context``) every rank holds its
shards of the parameters (``distributed.sharding.place``) and its data
slice of the batch: the embedding is vocabulary-parallel where the rules
shard its rows (each rank looks up its rows, the partial sums reduced at
the ``act_btd`` site), the logits are the lm_head's (or tied embedding's)
column shards, which the loss reduces with a vocabulary-parallel
log-sum-exp, and `lm_loss` divides a global sum by the global token count.

"A" blocks of an MoE stack (``cfg.family == "moe"``) run attention, then
`models.moe.apply_moe` on the second norm, then the shared expert or the
dense residual FFN beside it (``x + moe + extra``; when a config sets
both, the dense FFN's output replaces the shared expert's, as in the JAX
package).  `forward` returns the router's aux loss (the mean over the
layers of each MoE block's) when asked, and `lm_loss` adds it.

Training (`lm_loss`, ``launch.steps.make_train_step``) runs the same
forward under autograd, with ``Runtime.remat`` choosing what each block
keeps for the backward (`_remat`): everything (``"none"``), the outputs of
its matmuls only (``"dots"``) or nothing, recomputing the block
(``"full"``).  Remat never changes the numbers.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from ..core.quant_plan import join_site
from ..distributed.sharding import (dp_size, dp_sum, tp_copy_in, tp_rank,
                                    tp_reduce, tp_size)
from ..distributed.tensor_parallel import (column_dense, gather_columns,
                                           vocab_embed, vocab_xent)
from .attention import apply_attention, init_attention, init_attn_cache
from .common import normal_init, rms_norm, sinusoidal_pos_embed
from .ffn import apply_ffn, init_ffn
from .moe import apply_moe, init_moe
from .rglru import apply_rglru, init_rglru, init_rglru_cache
from .ssm import apply_mamba, init_mamba, init_mamba_cache

#: the cache key of each ported block type
CACHE_KIND = {"A": "attn", "M": "mamba", "R": "lru"}
#: the routing leaves a step binds into paged caches (not stacked per layer)
ROUTING = ("tbl", "slots")


def _check_supported(cfg) -> None:
    blocks = tuple(cfg.pattern) + tuple(cfg.tail)
    unknown = sorted(set(blocks) - set(CACHE_KIND))
    if unknown:
        raise NotImplementedError(
            f"{cfg.name}: block types {unknown} are not ported")


# ----------------------------------------------------------------- blocks --
def init_block(gen: torch.Generator, block_type: str, cfg,
               pack_expert=None) -> Dict:
    """One block's f32 parameters, drawn in the JAX package's leaf order;
    `pack_expert` goes to `init_moe`."""
    D, dev = cfg.d_model, gen.device
    p: Dict = {"norm1": torch.ones((D,), device=dev)}
    if block_type == "A":
        p["attn"] = init_attention(gen, cfg)
        if cfg.family == "moe":
            p["norm2"] = torch.ones((D,), device=dev)
            p["moe"] = init_moe(gen, cfg, pack_expert)
            if cfg.shared_expert:
                p["shared"] = init_ffn(gen, cfg, cfg.d_ff_expert or cfg.d_ff)
            if cfg.moe_dense_ff:
                p["dense_ffn"] = init_ffn(gen, cfg, cfg.moe_dense_ff)
        elif cfg.d_ff:
            p["norm2"] = torch.ones((D,), device=dev)
            p["ffn"] = init_ffn(gen, cfg)
    elif block_type == "M":
        p["mamba"] = init_mamba(gen, cfg)
    elif block_type == "R":
        p["lru"] = init_rglru(gen, cfg)
        if cfg.d_ff:
            p["norm2"] = torch.ones((D,), device=dev)
            p["ffn"] = init_ffn(gen, cfg)
    else:
        raise ValueError(block_type)
    return p


def init_block_cache(block_type: str, cfg, rt, batch: int, seq: int,
                     device="cuda") -> Dict:
    """One block's contiguous cache: the attention ring, the Mamba state or
    the RG-LRU state."""
    if block_type == "A":
        return {"attn": init_attn_cache(cfg, rt, batch, seq, device)}
    if block_type == "M":
        return {"mamba": init_mamba_cache(cfg, batch, device)}
    if block_type == "R":
        return {"lru": init_rglru_cache(cfg, batch, device)}
    raise ValueError(block_type)


def apply_block(block_type: str, p: Dict, x, cfg, rt, positions,
                cache=None, update_cache: bool = False, site: str = ""):
    """One block; `site` (e.g. "block[3]") prefixes the sub-layers' plan
    sites.  "A": attention, "R": RG-LRU, each then the FFN when ``d_ff``
    (an MoE stack's "A": the MoE block and its shared or dense FFN);
    "M": Mamba-2 (no FFN).  Returns (x, the block's new cache or None,
    the router's aux loss: an f32 scalar, or None outside MoE blocks)."""
    aux = None
    normed = rms_norm(x, p["norm1"], cfg.norm_eps)
    kind = CACHE_KIND[block_type]
    sub = cache.get(kind) if cache else None
    if block_type == "A":
        h, nc = apply_attention(p["attn"], normed, cfg, rt, positions, sub,
                                update_cache, site=site)
    else:
        mixer = apply_mamba if block_type == "M" else apply_rglru
        h, nc = mixer(p[kind], normed, cfg, rt, sub, update_cache,
                      site=join_site(site, kind))
    x = x + h
    if block_type == "A" and cfg.family == "moe":
        n2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        my, aux = apply_moe(p["moe"], n2, cfg, rt,
                            site=join_site(site, "moe"))
        extra = 0.0
        if cfg.shared_expert:
            extra = apply_ffn(p["shared"], n2, cfg, rt,
                              site=join_site(site, "shared"),
                              d_ff=cfg.d_ff_expert or cfg.d_ff)
        if cfg.moe_dense_ff:
            extra = apply_ffn(p["dense_ffn"], n2, cfg, rt,
                              site=join_site(site, "dense_ffn"),
                              d_ff=cfg.moe_dense_ff)
        x = x + my + extra
    elif block_type != "M" and cfg.d_ff:
        x = x + apply_ffn(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps),
                          cfg, rt, site=join_site(site, "ffn"))
    return x, ({kind: nc} if nc is not None else None), aux


# ------------------------------------------------------------------ model --
def _stack(trees: List[Dict]) -> Dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _fill_slice(stacked: Optional[Dict], tree: Dict, r: int,
                n: int) -> Dict:
    """`tree` written as slice r of `stacked` (allocated [n, ...] leaf by
    leaf when None)."""
    if stacked is None:
        stacked = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            stacked[k] = _fill_slice(stacked.get(k), v, r, n)
        else:
            if k not in stacked:
                stacked[k] = v.new_empty((n,) + tuple(v.shape))
            stacked[k][r] = v
    return stacked


def init_model(gen: torch.Generator, cfg, packer=None) -> Dict:
    """Random f32 parameters on the generator's device.  The generator is
    drawn block by block (the embedding, the lm_head, repeat 0's unit,
    repeat 1's, ..., then the tail); each block's leaves are copied into
    their stacked leaf at once, so the build never holds more than one
    block beside the stack.  With a `packer` (``core.quant_plan.
    LayerPacker``) every block is packed for its plan before it is stored,
    its expert stacks expert by expert, and the stacked ``layers`` become
    a list of per-block trees when the plan packs layers differently."""
    _check_supported(cfg)
    Vp, D = cfg.vocab_padded, cfg.d_model
    params: Dict = {
        "embed": {"tok": normal_init(gen, (Vp, D), fan_in=D)},
        "final_norm": torch.ones((D,), device=gen.device),
    }
    if not cfg.tie_embeddings:
        w = normal_init(gen, (D, Vp))
        params["lm_head"] = {"w": packer.lm_head(w) if packer else w}
    P, R = len(cfg.pattern), cfg.n_repeats

    def block(i: int, bt: str) -> Dict:
        if packer is None:
            return init_block(gen, bt, cfg)
        return packer.block(init_block(gen, bt, cfg, packer.experts(i)), i)

    if packer is not None and not packer.uniform:
        params["layers"] = [block(r * P + j, bt) for r in range(R)
                            for j, bt in enumerate(cfg.pattern)]
    else:
        stacked: List[Optional[Dict]] = [None] * P
        for r in range(R):
            for j, bt in enumerate(cfg.pattern):
                stacked[j] = _fill_slice(stacked[j], block(r * P + j, bt),
                                         r, R)
        params["layers"] = {f"u{j}": stacked[j] for j in range(P)}
    for t, bt in enumerate(cfg.tail):
        params[f"tail{t}"] = block(R * P + t, bt)
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


def _unbind(tree, n: int) -> List:
    """The n per-repeat views of a layer-stacked tree, each leaf split by
    one ``torch.unbind``: under autograd its backward stacks the n
    gradients once, where n separate slices would each add a whole-stack
    gradient."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    return list(torch.unbind(tree, 0))


def layer_params(params: Dict, cfg) -> List[Dict]:
    """Per-block views of the stacked repeat-unit parameters (block
    ``r * P + j`` at index ``r * P + j``), or the per-block trees of a plan
    that packs layers differently (``plan_pack_tree``)."""
    if isinstance(params["layers"], list):
        return params["layers"]
    P, R = len(cfg.pattern), cfg.n_repeats
    units = [_unbind(params["layers"][f"u{j}"], R) for j in range(P)]
    return [units[j][r] for r in range(R) for j in range(P)]


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


#: the matmuls whose outputs ``remat="dots"`` keeps: the dots with no
#: batch dimension, as the JAX package's ``dots_with_no_batch_dims_saveable``
#: (a projection of [B, S, D] activations folds to one ``mm``; attention's
#: and the experts' batched products, ``bmm``, are recomputed)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(rt, fn, x: torch.Tensor, lp) -> Tuple:
    """`fn(x)` (one block) under ``rt.remat`` when it is differentiated:
    ``"full"`` keeps only the block's input and recomputes the rest in
    the backward, ``"dots"`` keeps the outputs of its unbatched matmuls
    too (`_save_dots`), ``"none"`` (or no gradient) runs it as it is."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    def differentiated(node) -> bool:
        if isinstance(node, dict):
            return any(differentiated(v) for v in node.values())
        return isinstance(node, torch.Tensor) and node.requires_grad

    if rt.remat == "none" or not torch.is_grad_enabled() or not (
            x.requires_grad or differentiated(lp)):
        return fn(x)
    if rt.remat == "full":
        return checkpoint(fn, x, use_reentrant=False)
    if rt.remat == "dots":
        return checkpoint(fn, x, use_reentrant=False, context_fn=functools.
                          partial(create_selective_checkpoint_contexts,
                                  _save_dots))
    raise ValueError(f"unknown remat {rt.remat!r}: none | dots | full")


def forward(params: Dict, tokens: torch.Tensor, cfg, rt,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Dict] = None, update_cache: bool = False,
            return_hidden: bool = False, return_aux: bool = False):
    """tokens [B, S] -> (logits_or_hidden, caches), and the router's aux
    loss (the mean over the layers of every block's) after them when
    `return_aux`.  `positions` is
    [B, S] (default 0..S-1 in every row), or [3, B, S] for an M-RoPE stack
    (the temporal stream ``positions[0]`` addresses the caches).  Paged
    pools (with
    bound block tables, ``serving.kv_pages``) are updated in place and
    returned; contiguous caches come back as a new tree (a block whose cache
    did not change keeps its old one)."""
    _check_supported(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).repeat(B, 1)
    dt = torch.bfloat16 if rt.compute_dtype == "bfloat16" else torch.float32
    x, partial = vocab_embed(params["embed"]["tok"], tokens, cfg.vocab_padded)
    x = (tp_reduce(x) if partial else x).to(dt)
    if cfg.rope == "none":
        tpos = positions if positions.dim() == 2 else positions[0]
        x = x + sinusoidal_pos_embed(tpos, cfg.d_model).to(dt)
    layers = params.get("layer_views") or layer_params(params, cfg)
    P = len(cfg.pattern)
    new_rep: Dict[str, List] = {f"u{j}": [] for j in range(P)}
    auxes = []                       # the MoE blocks' router aux losses
    for i, lp in enumerate(layers):
        r, j = divmod(i, P)
        if caches is None:
            def block(xb, lp=lp, bt=cfg.pattern[j], i=i):
                xb, _, aux = apply_block(bt, lp, xb, cfg, rt, positions,
                                         site=f"block[{i}]")
                return xb, aux

            x, aux = _remat(rt, block, x, lp)
            auxes.append(aux)
            continue
        cache = _layer_cache(caches["rep"][f"u{j}"], r)
        x, nc, aux = apply_block(cfg.pattern[j], lp, x, cfg, rt, positions,
                                 cache, update_cache, site=f"block[{i}]")
        auxes.append(aux)
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
        x, nc, aux = apply_block(bt, params[f"tail{t}"], x, cfg, rt,
                                 positions, tc, update_cache,
                                 site=f"block[{cfg.n_repeats * P + t}]")
        auxes.append(aux)
        if new_caches is not None:
            new_caches["tail"][f"tail{t}"] = (tc if nc is None or _paged(tc)
                                              else nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out = x if return_hidden else _logits(params, x, cfg, rt)
    if return_aux:
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for aux in auxes:
            if aux is not None:
                aux_sum = aux_sum + aux
        return out, new_caches, aux_sum / max(cfg.n_layers, 1)
    return out, new_caches


def _vocab_logits(params, x, cfg, rt):
    """x [..., D] -> (logits [..., V_local], first column, sharded): the
    tied embedding product in the activation dtype (a plain large matmul,
    as the JAX package leaves it to XLA), or the plan's lm_head site; this
    rank's vocabulary columns where the rules shard them."""
    Vp = cfg.vocab_padded
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(x.dtype)                  # [Vp, D]
        sharded = tp_size() > 1 and w.shape[0] != Vp
        logits = torch.matmul(tp_copy_in(x) if sharded else x, w.t())
    else:
        logits, sharded = column_dense(
            params["lm_head"]["w"], x, rt.quant_cfg(cfg, "lm_head"),
            tag="lm_head", n_out=Vp)
    return logits, (tp_rank() * logits.shape[-1] if sharded else 0), sharded


def _logits(params, x, cfg, rt):
    """x [..., D] -> logits [..., Vp], every column on every rank."""
    logits, _, sharded = _vocab_logits(params, x, cfg, rt)
    return gather_columns(logits, sharded)


# ------------------------------------------------------------------- loss --
def lm_loss(params: Dict, tokens: torch.Tensor, cfg, rt,
            positions: Optional[torch.Tensor] = None):
    """Next-token cross-entropy of tokens [B, S+1] (inputs and targets
    shifted by one) -> (loss, {"nll", "aux"}), as the JAX package computes
    it: the hidden states flattened to [B*S, D] and the per-token losses
    summed over ``rt.loss_chunk`` rows at a time (a Python loop where the
    JAX package scans; 0, or a chunk that does not divide B*S or is not
    smaller, computes them at once), divided by B*S; plus
    ``cfg.router_aux_coef * aux`` for an MoE stack.  Under a mesh with
    more than one data rank, `tokens` are this rank's rows of the global
    batch: the sum is divided by the global count and the aux by the data
    ranks, so the rank's gradient is its share of the global one, and the
    loss, nll and aux returned are the global values."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    hidden, _, aux = forward(params, inp, cfg, rt, positions,
                             return_hidden=True, return_aux=True)
    B, S, D = hidden.shape
    hf = hidden.reshape(B * S, D)
    tf = tgt.reshape(B * S)
    chunk = rt.loss_chunk
    if chunk and (B * S) % chunk == 0 and (B * S) > chunk:
        total = torch.zeros((), dtype=torch.float32, device=hf.device)
        for c in range(0, B * S, chunk):
            total = total + torch.sum(_xent(params, hf[c:c + chunk],
                                            tf[c:c + chunk], cfg, rt))
    else:
        total = torch.sum(_xent(params, hf, tf, cfg, rt))
    dp = dp_size()
    if dp == 1:
        nll = total / (B * S)
        loss = nll + cfg.router_aux_coef * aux if cfg.n_experts else nll
        return loss, {"nll": nll, "aux": aux}
    # this data rank's share of the global mean (its gradient is the
    # rank's part of the global gradient); the value is the global loss
    nll = total / (B * S * dp)
    local = nll + cfg.router_aux_coef * aux / dp if cfg.n_experts else nll
    loss = local + (dp_sum(local) - local).detach()
    return loss, {"nll": dp_sum(nll), "aux": dp_sum(aux) / dp}


def _xent(params, h, t, cfg, rt):
    """Per-row cross-entropy of hidden rows h [n, D] against targets t [n]:
    float32 logits, the padded vocabulary's columns masked to -1e30
    (vocabulary-parallel where the logits are sharded)."""
    logits, v0, sharded = _vocab_logits(params, h, cfg, rt)
    return vocab_xent(logits.to(torch.float32), t, cfg.vocab, v0, sharded)


# ------------------------------------------------------------ serve steps --
def prefill(params, tokens, cfg, rt, caches, positions=None):
    """Fill caches with a prompt; returns (last_logits [B, Vp], caches)."""
    hidden, caches = forward(params, tokens, cfg, rt, positions, caches,
                             update_cache=True, return_hidden=True)
    return _logits(params, hidden[:, -1:], cfg, rt)[:, 0], caches


def decode_step(params, token, cfg, rt, caches, positions):
    """One decode step. token [B, 1]; positions [B, 1] absolute positions
    (or [3, B, 1], the M-RoPE streams)."""
    hidden, caches = forward(params, token, cfg, rt, positions, caches,
                             update_cache=True, return_hidden=True)
    return _logits(params, hidden, cfg, rt)[:, 0], caches
