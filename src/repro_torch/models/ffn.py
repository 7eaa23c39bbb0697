"""Dense FFN blocks: SwiGLU (llama-family) and GELU with biases
(starcoder2, musicgen), every projection through the quantized linear
(PyTorch port of ``repro/models/ffn.py``)."""

from __future__ import annotations

from typing import Dict

import torch

from ..core.qlinear import qdense
from ..core.quant_plan import join_site
from .common import gelu_tanh, normal_init, silu


def init_ffn(gen: torch.Generator, cfg, d_ff: int = 0) -> Dict:
    """``w_in [D, F]``, ``w_out [F, D]`` and, for SwiGLU, ``w_gate [D, F]``,
    drawn in that order; with ``cfg.mlp_bias`` zero ``b_in [F]`` and
    ``b_out [D]`` (no draw).  `d_ff` overrides ``cfg.d_ff`` (MoE's shared
    expert and arctic's dense residual FFN)."""
    D, F = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_in": normal_init(gen, (D, F)),
         "w_out": normal_init(gen, (F, D), fan_in=F)}
    if cfg.ffn_type == "swiglu":
        p["w_gate"] = normal_init(gen, (D, F))
    if cfg.mlp_bias:
        p["b_in"] = torch.zeros((F,), device=gen.device)
        p["b_out"] = torch.zeros((D,), device=gen.device)
    return p


def apply_ffn(params: Dict, x: torch.Tensor, cfg, rt,
              site: str = "ffn") -> torch.Tensor:
    s_in, s_gate, s_out = (join_site(site, "w_in"), join_site(site, "w_gate"),
                           join_site(site, "w_out"))
    h = qdense(params["w_in"], x, rt.quant_cfg(cfg, s_in),
               params.get("b_in"), tag=s_in)
    if cfg.ffn_type == "swiglu":
        g = qdense(params["w_gate"], x, rt.quant_cfg(cfg, s_gate), tag=s_gate)
        h = silu(g) * h
    else:
        h = gelu_tanh(h)
    return qdense(params["w_out"], h, rt.quant_cfg(cfg, s_out),
                  params.get("b_out"), tag=s_out)
