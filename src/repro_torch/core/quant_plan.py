"""Site-addressable quantization plans (PyTorch port of
``repro/core/quant_plan.py``).

A ``QuantPlan`` maps glob-style site patterns to per-site ``QuantConfig``s.
Site names are hierarchical (``block[<i>].attn.qkv``, ``block[<i>].attn.wo``,
``block[<i>].ffn.{w_in,w_gate,w_out}``, ``lm_head``).  ``*``/``?`` are
wildcards; a pattern matches the full site or any ``.``-aligned suffix; the
matching pattern with the most literal characters wins, later rules break
ties.

Ported: resolution, the uniform plan behind ``Runtime.quant_backend``,
``plan_pack_tree`` and ``pack_for_serving``.  Presets and the inline/JSON
plan parsers (the JAX package's ``Runtime.quant_plan``) wait for a later
slice.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, Optional, Tuple

import torch

from .qlinear import QuantConfig

#: backends the live serving path packs ahead of time
SERVE_PACKED = frozenset({"w4a4_packed", "w4a16_packed"})


def join_site(prefix: str, leaf: str) -> str:
    """``"block[3]" + "attn.qkv" -> "block[3].attn.qkv"``; empty prefix ok."""
    return f"{prefix}.{leaf}" if prefix else leaf


@functools.lru_cache(maxsize=4096)
def _compiled(pattern: str) -> "re.Pattern[str]":
    out = []
    for ch in pattern:
        if ch == "*":
            out.append(".*")
        elif ch == "?":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out) + r"\Z")


def pattern_matches(pattern: str, site: str) -> bool:
    """Full-site or dot-aligned-suffix glob match with literal brackets."""
    rx = _compiled(pattern)
    if rx.match(site):
        return True
    idx = site.find(".")
    while idx != -1:
        if rx.match(site[idx + 1:]):
            return True
        idx = site.find(".", idx + 1)
    return False


def specificity(pattern: str) -> int:
    """Number of literal (non-wildcard) characters — the precedence key."""
    return len(pattern) - pattern.count("*") - pattern.count("?")


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """Ordered (pattern, QuantConfig) rules; frozen and hashable."""

    rules: Tuple[Tuple[str, QuantConfig], ...]
    name: str = ""

    def resolve(self, site: str) -> QuantConfig:
        return _resolve(self, site)

    @property
    def backends(self) -> frozenset:
        return frozenset(qc.backend for _, qc in self.rules)


@functools.lru_cache(maxsize=65536)
def _resolve(plan: QuantPlan, site: str) -> QuantConfig:
    best: Optional[QuantConfig] = None
    best_key = (-1, -1)
    for i, (pattern, qc) in enumerate(plan.rules):
        if not pattern_matches(pattern, site):
            continue
        key = (specificity(pattern), i)
        if key > best_key:
            best, best_key = qc, key
    if best is None:
        raise ValueError(
            f"site {site!r} matches no rule of plan "
            f"{plan.name or plan.rules!r}; add a catch-all '*' rule")
    return best


@functools.lru_cache(maxsize=256)
def uniform_plan(qc: QuantConfig) -> QuantPlan:
    """One QuantConfig as a plan; lm_head stays float unless the config
    opts in via quantize_embedding."""
    rules: Tuple[Tuple[str, QuantConfig], ...] = (("*", qc),)
    if qc.quantized and not qc.quantize_embedding:
        rules += (("lm_head", dataclasses.replace(qc, backend="float")),)
    return QuantPlan(rules=rules, name=f"uniform_{qc.backend}")


def active_plan(arch, rt) -> QuantPlan:
    """The plan in effect for (arch, runtime): ``Runtime.quant_backend``
    mapped to a uniform plan, else the uniform ``ArchConfig.quant``.  Plan
    specs (``ArchConfig.quant_plan``; the JAX package's
    ``Runtime.quant_plan``) are not ported yet and raise."""
    if arch.quant_plan:
        raise NotImplementedError(
            "quant plan specs (presets, JSON, inline rules) are not ported "
            "yet; use Runtime.quant_backend")
    if rt.quant_backend is not None:
        return uniform_plan(
            dataclasses.replace(arch.quant, backend=rt.quant_backend))
    return uniform_plan(arch.quant)


def block_leaf_sites(block_type: str, cfg) -> Tuple[str, ...]:
    """The quantizable leaf sites inside one attention block."""
    if block_type != "A" or cfg.family != "dense":
        raise NotImplementedError(
            f"block type {block_type!r} / family {cfg.family!r} is not "
            f"ported yet")
    sites = ["attn.qkv", "attn.wo"]
    if cfg.d_ff:
        sites += ["ffn.w_in", "ffn.w_gate", "ffn.w_out"]
    return tuple(sites)


@functools.lru_cache(maxsize=1024)
def plan_repeat_uniform(plan: QuantPlan, cfg) -> bool:
    """True iff every repeat unit resolves to the same per-site configs as
    repeat 0 (the stacked layer weights can then be packed in place)."""
    P = len(cfg.pattern)
    for j, bt in enumerate(cfg.pattern):
        for leaf in block_leaf_sites(bt, cfg):
            base = plan.resolve(f"block[{j}].{leaf}")
            for r in range(1, cfg.n_repeats):
                if plan.resolve(f"block[{r * P + j}].{leaf}") != base:
                    return False
    return True


def _leaf_site(comps: Tuple[str, ...]) -> str:
    """Block-relative param path -> site leaf (wq/wk/wv share attn.qkv)."""
    if comps and comps[0] == "attn" and comps[-1] in ("wq", "wk", "wv"):
        return "attn.qkv"
    return ".".join(comps)


def plan_pack_tree(params, cfg, plan: QuantPlan, *,
                   min_size: int = 1 << 12,
                   backends: frozenset = SERVE_PACKED,
                   scale_dtype=torch.float32,
                   site_log: Optional[Dict[str, str]] = None):
    """Pack model weights into the int4 serving format per resolved site.

    Sites whose backend is outside ``backends`` keep their float masters, as
    do leaves under ``min_size`` elements (counted over the layer-stacked
    leaf, as the JAX package counts them).  Only repeat-uniform plans are
    ported: the stacked ``layers`` tree packs in place."""
    from .qlinear import PACKABLE_NAMES, pack_weight_nd

    def pack_leaf(leaf, site: str, *, check_name: Optional[str] = None):
        qc = plan.resolve(site)
        packable = (
            qc.backend in backends
            and (check_name is None or check_name in PACKABLE_NAMES)
            and isinstance(leaf, torch.Tensor)
            and leaf.ndim >= 2
            and leaf.numel() >= min_size
            and leaf.shape[-1] % 2 == 0
            and leaf.dtype in (torch.float32, torch.bfloat16)
        )
        if not packable:
            return leaf
        if site_log is not None:
            site_log[site] = qc.backend
        if qc.backend not in ("w4a16", "w4a16_packed"):
            qc = dataclasses.replace(qc, group_size=0)
        packed = pack_weight_nd(leaf.to(torch.float32), qc)
        packed["scale"] = packed["scale"].to(scale_dtype)
        return packed

    def pack_block(bp, prefix: str):
        def rec(node, comps):
            if isinstance(node, dict):
                return {k: rec(v, comps + (k,)) for k, v in node.items()}
            return pack_leaf(node, join_site(prefix, _leaf_site(comps)),
                             check_name=comps[-1])
        return rec(bp, ())

    if not plan_repeat_uniform(plan, cfg):
        raise NotImplementedError(
            "plans that differ between repeats are not ported yet")
    out = dict(params)
    out["layers"] = {f"u{j}": pack_block(params["layers"][f"u{j}"],
                                         f"block[{j}]")
                     for j in range(len(cfg.pattern))}
    if "lm_head" in params:
        out["lm_head"] = {"w": pack_leaf(params["lm_head"]["w"], "lm_head")}
    return out


def pack_for_serving(params, cfg, rt):
    """Serving-side weight preparation under the active plan: pack the
    sites whose backend pre-packs, then add the planar K-major twins the
    W4A4 kernel reads (on every device: the plain version reads them too,
    so one tree serves both).  No-op when the plan never pre-packs."""
    from .qlinear import prepack_tree

    plan = active_plan(cfg, rt)
    if not (plan.backends & SERVE_PACKED):
        return params
    return prepack_tree(plan_pack_tree(params, cfg, plan,
                                       backends=SERVE_PACKED))
