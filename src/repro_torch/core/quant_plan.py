"""Site-addressable quantization plans (PyTorch port of
``repro/core/quant_plan.py``).

A ``QuantPlan`` maps glob-style site patterns to per-site ``QuantConfig``s.
Site names are hierarchical (``block[<i>].attn.qkv``, ``block[<i>].attn.wo``,
``block[<i>].ffn.{w_in,w_gate,w_out}``, ``lm_head``).  ``*``/``?`` are
wildcards; a pattern matches the full site or any ``.``-aligned suffix; the
matching pattern with the most literal characters wins, later rules break
ties.

Plans come from three spec forms (``get_plan``): a named preset
(``PRESETS``), a JSON file path, or inline ``pattern=backend[/g<G>][/w<b>]
[/a<b>][;...]`` rules; ``active_plan`` gives ``Runtime.quant_plan``
precedence over ``Runtime.quant_backend``, then ``ArchConfig.quant_plan``,
then the uniform ``ArchConfig.quant``.  A plan that resolves the same at
every layer packs the stacked ``layers`` tree in place; one that differs
between layers splits it into a list of per-layer trees, which the port's
Python layer loop walks as it walks the stacked views.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
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


# ---------------------------------------------------------- plan specs ----
_QC_FIELDS = ("backend", "w_bits", "a_bits", "group_size",
              "quantize_embedding")


def plan_from_dict(d: Dict) -> QuantPlan:
    rules = tuple(
        (r["pattern"], QuantConfig(**{f: r[f] for f in _QC_FIELDS if f in r}))
        for r in d["rules"])
    return QuantPlan(rules=rules, name=d.get("name", ""))


def _parse_inline(spec: str) -> QuantPlan:
    """``"block[0].*=float;ffn.*=w4a16/g128;*=int_sim"`` -> QuantPlan."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        pattern, _, rhs = part.partition("=")
        if not rhs:
            raise ValueError(
                f"bad plan rule {part!r}: expected pattern=backend")
        backend, *opts = rhs.split("/")
        kw = {"backend": backend.strip()}
        for opt in opts:
            if opt.startswith("g"):
                kw["group_size"] = int(opt[1:])
            elif opt.startswith("w"):
                kw["w_bits"] = int(opt[1:])
            elif opt.startswith("a"):
                kw["a_bits"] = int(opt[1:])
            else:
                raise ValueError(f"unknown plan option {opt!r} in {part!r}")
        rules.append((pattern.strip(), QuantConfig(**kw)))
    return QuantPlan(rules=tuple(rules), name="inline")


_FLOAT = QuantConfig(backend="float")

#: named presets, the JAX package's, rule for rule
PRESETS: Dict[str, QuantPlan] = {
    # uniform W4A4 integer GEMMs; lm_head stays float
    "uniform_w4a4": QuantPlan(
        name="uniform_w4a4",
        rules=(("*", QuantConfig(backend="int_sim")),
               ("lm_head", _FLOAT)),
    ),
    # weight-only int4 everywhere except the sensitive sites, which stay fp
    "w4a16_sensitive_fp": QuantPlan(
        name="w4a16_sensitive_fp",
        rules=(("*", QuantConfig(backend="w4a16", a_bits=16, group_size=128)),
               ("block[0].*", _FLOAT),
               ("lm_head", _FLOAT)),
    ),
    # QAT with the first block and head in full precision
    "qat_mixed": QuantPlan(
        name="qat_mixed",
        rules=(("*", QuantConfig(backend="fake_quant")),
               ("block[0].*", _FLOAT),
               ("lm_head", _FLOAT)),
    ),
    # pre-packed W4A4 serving (`--quant w4a4_packed` as a plan)
    "serve_w4a4": QuantPlan(
        name="serve_w4a4",
        rules=(("*", QuantConfig(backend="w4a4_packed")),
               ("lm_head", _FLOAT)),
    ),
    # w4a16 FFNs, float lm_head and block-0 attention, int_sim elsewhere
    "mixed_sensitive": QuantPlan(
        name="mixed_sensitive",
        rules=(("*", QuantConfig(backend="int_sim")),
               ("ffn.*", QuantConfig(backend="w4a16", a_bits=16)),
               ("block[0].attn.*", _FLOAT),
               ("lm_head", _FLOAT)),
    ),
}

_PLAN_CACHE: Dict[str, QuantPlan] = {}


def get_plan(spec: str) -> QuantPlan:
    """Resolve a plan spec: preset name | JSON file path | inline rules.
    File plans are cached per (path, mtime), so an edited file is read
    again."""
    if spec in PRESETS:
        return PRESETS[spec]
    key = spec
    is_file = spec.endswith(".json") or os.path.exists(spec)
    if is_file:
        try:
            key = f"{spec}@{os.stat(spec).st_mtime_ns}"
        except OSError:
            pass
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    if is_file:
        with open(spec) as f:
            plan = plan_from_dict(json.load(f))
    elif "=" in spec:
        plan = _parse_inline(spec)
    else:
        raise ValueError(
            f"unknown quant plan {spec!r}: not a preset "
            f"({sorted(PRESETS)}), not a file, and not inline rules "
            "(pattern=backend[;...])")
    _PLAN_CACHE[key] = plan
    return plan


@functools.lru_cache(maxsize=256)
def uniform_plan(qc: QuantConfig) -> QuantPlan:
    """One QuantConfig as a plan; lm_head stays float unless the config
    opts in via quantize_embedding."""
    rules: Tuple[Tuple[str, QuantConfig], ...] = (("*", qc),)
    if qc.quantized and not qc.quantize_embedding:
        rules += (("lm_head", dataclasses.replace(qc, backend="float")),)
    return QuantPlan(rules=rules, name=f"uniform_{qc.backend}")


def active_plan(arch, rt) -> QuantPlan:
    """The plan in effect for (arch, runtime).  Precedence:
    ``Runtime.quant_plan`` (name | path | inline) > ``Runtime.quant_backend``
    (as a uniform plan) > ``ArchConfig.quant_plan`` > uniform
    ``ArchConfig.quant``."""
    if rt.quant_plan:
        return get_plan(rt.quant_plan)
    if rt.quant_backend is not None:
        return uniform_plan(
            dataclasses.replace(arch.quant, backend=rt.quant_backend))
    if arch.quant_plan:
        return get_plan(arch.quant_plan)
    return uniform_plan(arch.quant)


def block_leaf_sites(block_type: str, cfg) -> Tuple[str, ...]:
    """The quantizable leaf sites inside one block of the given type
    (relative to the block's ``block[<i>]`` prefix): attention blocks of a
    dense stack, and Mamba-2 blocks."""
    if block_type == "M":
        return ("mamba.in_proj", "mamba.out_proj")
    if block_type != "A" or cfg.family == "moe":
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
    leaf, as the JAX package counts them).  A repeat-uniform plan packs the
    stacked ``layers`` tree in place; any other splits it into a list of
    per-block trees, block ``r * P + j`` at index ``r * P + j`` (the JAX
    package's ``{"r<r>": {"u<j>": ...}}``).  Tail blocks pack under their
    own sites."""
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

    P, R = len(cfg.pattern), cfg.n_repeats
    out = dict(params)
    if plan_repeat_uniform(plan, cfg):
        out["layers"] = {f"u{j}": pack_block(params["layers"][f"u{j}"],
                                             f"block[{j}]")
                         for j in range(P)}
    else:
        out["layers"] = [
            pack_block(layer_slice(params["layers"][f"u{j}"], r),
                       f"block[{r * P + j}]")
            for r in range(R) for j in range(P)]
    for t in range(len(cfg.tail)):
        out[f"tail{t}"] = pack_block(params[f"tail{t}"],
                                     f"block[{R * P + t}]")
    if "lm_head" in params:
        out["lm_head"] = {"w": pack_leaf(params["lm_head"]["w"], "lm_head")}
    return out


def layer_slice(tree, r: int):
    """Layer r of a layer-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, r) for k, v in tree.items()}
    return tree[r]


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
