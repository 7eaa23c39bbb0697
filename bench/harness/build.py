"""The system under test, built from a configuration file: the port's
config, runtime and serving settings, weights packed by the port's own
layer-at-a-time packer from masters the benchmark draws itself
(`reference.masters`), and the engine behind the port's `ServingAPI`."""

from __future__ import annotations

import dataclasses
from typing import Dict

from reference.masters import dims, draw_block, draw_globals

from .manifest import as_run


def port_configs(cfgfile: Dict):
    """(ArchConfig, Runtime, ServingConfig) of the port for a configuration
    file.  The port's architecture is its registry entry at the file's
    depth; every width the reference reads from the file must be the
    port's, or the two would compute different models."""
    from repro_torch.configs import Runtime, ServingConfig, get_config

    model, s = as_run(cfgfile), cfgfile["serving"]
    d = dims(model)
    cfg = dataclasses.replace(get_config(cfgfile["arch"]), n_layers=d["L"])
    have = {"D": cfg.d_model, "H": cfg.n_heads, "KV": cfg.n_kv_heads,
            "hd": cfg.hd, "F": cfg.d_ff, "V": cfg.vocab_padded,
            "gated": cfg.ffn_type == "swiglu", "qkv_bias": cfg.qkv_bias,
            "mlp_bias": cfg.mlp_bias,
            "rope_theta": cfg.rope_theta, "eps": cfg.norm_eps}
    want = {**{k: d[k] for k in ("D", "H", "KV", "hd", "F", "V", "gated",
                                 "qkv_bias", "mlp_bias")},
            "rope_theta": float(model["rope_theta"]),
            "eps": float(model.get("rms_norm_eps",
                                   model.get("norm_epsilon", 0.0)))}
    bad = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    # a published window the port does not apply changes nothing while no
    # context reaches it
    window = int(model.get("sliding_window") or 0)
    if cfg.local_window != window and not (
            cfg.local_window == 0 and s["max_ctx"] <= window):
        bad["window"] = (cfg.local_window, window)
    if bad or cfg.rope != "rope" or cfg.qk_norm or cfg.tie_embeddings:
        raise ValueError(f"{cfgfile['arch']}: the port's config differs from "
                         f"the configuration file (port, file): {bad}")
    rt = Runtime(attn_impl=s["attn_impl"], quant_plan=s["quant_plan"],
                 cache_dtype=s["cache_dtype"],
                 compute_dtype=s["compute_dtype"])
    sv = ServingConfig(layout=s["layout"], step=s["step"],
                       max_batch=s["max_batch"], page_size=s["page_size"],
                       num_pages=s["num_pages"], max_ctx=s["max_ctx"],
                       prefix_cache=s["prefix_cache"])
    return cfg, rt, sv


def build_params(cfg, rt, model: Dict, seed: int, device):
    """The serving tree: the benchmark's masters, each block packed by the
    port's `LayerPacker` as soon as it is drawn (the build holds the packed
    model beside one block's masters)."""
    from repro_torch.core.quant_plan import LayerPacker, active_plan

    packer = LayerPacker(cfg, active_plan(cfg, rt))
    g = draw_globals(model, seed, device)
    params = {"embed": {"tok": g["embed"]}, "final_norm": g["final_norm"],
              "lm_head": {"w": packer.lm_head(g["lm_head"])}}
    del g
    params["layers"] = [packer.block(draw_block(model, seed, i, device), i)
                        for i in range(cfg.n_layers)]
    return params


def build_engine(cfgfile: Dict, seed: int, clock, device):
    from repro_torch.serving.api import ServingAPI
    from repro_torch.serving.engine import InferenceEngine

    cfg, rt, sv = port_configs(cfgfile)
    params = build_params(cfg, rt, as_run(cfgfile), seed, device)
    engine = InferenceEngine(cfg, rt, sv, params=params, clock=clock,
                             device=device)
    return engine, ServingAPI(engine)
