"""Dense FFN blocks: SwiGLU (llama-family) and GELU with biases
(starcoder2, musicgen), every projection through the quantized linear
(PyTorch port of ``repro/models/ffn.py``).  Under a mesh whose rules shard
the block (``ffn/w_in|w_gate`` by columns, ``ffn/w_out`` by rows, where
d_ff divides over ``model``) it runs Megatron style: the hidden [B, S, F]
stays sharded on F and the output's partial sums are reduced once
(``distributed.tensor_parallel``)."""

from __future__ import annotations

from typing import Dict

import torch

from ..core.quant_plan import join_site
from ..distributed.tensor_parallel import column_dense, row_dense
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
              site: str = "ffn", d_ff: int = 0) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]; `d_ff` is the block's hidden width (0:
    ``cfg.d_ff``), which tells a sharded weight from a whole one."""
    F = d_ff or cfg.d_ff
    s_in, s_gate, s_out = (join_site(site, "w_in"), join_site(site, "w_gate"),
                           join_site(site, "w_out"))
    h, sh = column_dense(params["w_in"], x, rt.quant_cfg(cfg, s_in),
                         params.get("b_in"), tag=s_in, n_out=F)
    if cfg.ffn_type == "swiglu":
        g, _ = column_dense(params["w_gate"], x, rt.quant_cfg(cfg, s_gate),
                            tag=s_gate, n_out=F)
        h = silu(g) * h
    else:
        h = gelu_tanh(h)
    return row_dense(params["w_out"], h, rt.quant_cfg(cfg, s_out),
                     params.get("b_out"), tag=s_out, k_in=F, x_sharded=sh)
