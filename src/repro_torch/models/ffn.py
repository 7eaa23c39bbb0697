"""SwiGLU FFN through the quantized linear (PyTorch port of
``repro/models/ffn.py``; the GELU variant waits for the configs that use
it)."""

from __future__ import annotations

from typing import Dict

import torch

from ..core.qlinear import qdense
from ..core.quant_plan import join_site
from .common import normal_init


def init_ffn(gen: torch.Generator, cfg, d_ff: int = 0) -> Dict:
    if cfg.ffn_type != "swiglu" or cfg.mlp_bias:
        raise NotImplementedError(
            "only the bias-free SwiGLU FFN is ported; the GELU FFN with "
            "biases comes with starcoder2-7b and musicgen-large (ROADMAP "
            "Queue 1 item 2b)")
    D, F = cfg.d_model, d_ff or cfg.d_ff
    return {"w_in": normal_init(gen, (D, F)),
            "w_out": normal_init(gen, (F, D), fan_in=F),
            "w_gate": normal_init(gen, (D, F))}


def apply_ffn(params: Dict, x: torch.Tensor, cfg, rt,
              site: str = "ffn") -> torch.Tensor:
    s_in, s_gate, s_out = (join_site(site, "w_in"), join_site(site, "w_gate"),
                           join_site(site, "w_out"))
    h = qdense(params["w_in"], x, rt.quant_cfg(cfg, s_in),
               params.get("b_in"), tag=s_in)
    g = qdense(params["w_gate"], x, rt.quant_cfg(cfg, s_gate), tag=s_gate)
    # silu as the JAX package evaluates it on its XLA path: x * logistic(x)
    # with logistic = 1 / (1 + exp(-x)), every op rounding to the activation
    # dtype.  A fused silu rounds once instead, and in bf16 that one-step
    # difference can move a whole row's int4 scale in the next projection.
    h = g * (1.0 / (1.0 + torch.exp(-g))) * h
    return qdense(params["w_out"], h, rt.quant_cfg(cfg, s_out),
                  params.get("b_out"), tag=s_out)
