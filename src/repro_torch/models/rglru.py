"""Griffin/RecurrentGemma recurrent block: conv1d + RG-LRU gated linear
recurrence (PyTorch port of ``repro/models/rglru.py``).

Block layout follows Griffin (arXiv:2402.19427): two input branches
(linear -> GeLU gate; linear -> conv1d -> RG-LRU), elementwise merge,
output projection.  The five projections go through the quantized linear,
so under ``--quant w4a4_packed`` they run the fused W4A4 GEMM; the gates'
biases ride on ``qdense``.  The recurrence runs in float32.

Every elementwise op keeps the JAX package's dtype and order: the tanh
GeLU and the sigmoid gates are composed op by op, each op rounding to the
activation dtype, as XLA evaluates them (a fused ``gelu`` or ``sigmoid``
rounds once, and in bf16 that differs in about half the elements).

Where the JAX package runs the prefill recurrence as ``lax.associative_scan``
(log depth), this port runs a doubling scan (Hillis-Steele: log2(S) steps
of ``h_t = a_t * h_{t-d} + h_t``): the same recurrence in float32, its
products in another order.  Decode (S == 1) is the one step
``h = a * h + gated``.

Caches are ``{"conv": [B, K-1, W] f32, "h": [B, W] f32}``; a step returns
a new cache dict (the JAX package's functional update).

Under a mesh the rules shard only the gate projections ``w_a``/``w_x``
(by columns); their outputs are made whole and the recurrence runs on
every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.qlinear import qdense
from ..distributed.tensor_parallel import column_dense, gather_columns
from ..core.quant_plan import join_site
from .common import gelu_tanh, normal_init
from .ssm import _causal_conv

_C = 8.0  # Griffin's fixed gate sharpness


def init_rglru(gen: torch.Generator, cfg) -> Dict:
    D, W, K = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.ssm_conv
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "in_x": normal_init(gen, (D, W)),
        "in_g": normal_init(gen, (D, W)),
        "conv_w": normal_init(gen, (K, W), fan_in=K),
        "conv_b": torch.zeros((W,), **f32),
        "w_a": normal_init(gen, (W, W)),
        "b_a": torch.zeros((W,), **f32),
        "w_x": normal_init(gen, (W, W)),
        "b_x": torch.zeros((W,), **f32),
        # Lambda init so a^c in ~[0.9, 0.999] (Griffin appendix)
        "lam": torch.log(torch.expm1(
            -torch.log(torch.linspace(0.9, 0.999, W, **f32)) / _C)),
        "out": normal_init(gen, (W, D), fan_in=W),
    }


def init_rglru_cache(cfg, batch: int, device="cuda") -> Dict:
    W = cfg.lru_width or cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, W), **f32),
            "h": torch.zeros((batch, W), **f32)}


def _logistic(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA evaluates it: 1 / (1 + exp(-x)), op by op
    in x's dtype."""
    return 1.0 / (1.0 + torch.exp(-x))


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every ``h_t = a_t * h_{t-1} + b_t`` along dim 1 from h = 0: log2(S)
    doubling steps, each folding step t - d into step t (the
    ``(a1 * a2, b1 * a2 + b2)`` combine of the JAX package's scan)."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def apply_rglru(params: Dict, x: torch.Tensor, cfg, rt,
                cache: Optional[Dict] = None, update_cache: bool = False,
                site: str = "lru") -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B, S, D] -> (y [B, S, D], new cache or None).  With a cache and
    S == 1: one recurrence step; otherwise the scan from the cache's state
    (zeros without a cache), its final state returned with
    `update_cache`."""
    B, S, _ = x.shape

    def dense(leaf, inp, bias=None):
        s = join_site(site, leaf)
        return qdense(params[leaf], inp, rt.quant_cfg(cfg, s), bias, tag=s)

    def gate(leaf, inp, bias):
        """The column-parallel gate projections (``lru/w_a|w_x``), made
        whole: the recurrence runs on every rank."""
        s, W = join_site(site, leaf), inp.shape[-1]
        y, sh = column_dense(params[leaf], inp, rt.quant_cfg(cfg, s), bias,
                             tag=s, n_out=W)
        return gather_columns(y, sh)

    g = gelu_tanh(dense("in_g", x))
    u = dense("in_x", x)
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv(u, params["conv_w"], params["conv_b"],
                               conv_state)

    f32 = torch.float32
    r = _logistic(gate("w_a", u, params["b_a"])).to(f32)
    i = _logistic(gate("w_x", u, params["b_x"])).to(f32)

    sp = torch.logaddexp(params["lam"], torch.zeros_like(params["lam"]))
    log_a = -_C * sp * r                                        # [B,S,W] <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = beta * i * u.to(f32)

    if cache is not None and S == 1:
        h = a[:, 0] * cache["h"] + gated[:, 0]                  # [B, W]
        hs = h[:, None]
        new_cache = {"conv": new_conv, "h": h}
    else:
        h0 = (cache["h"] if cache is not None
              else torch.zeros((B, u.shape[-1]), dtype=f32, device=x.device))
        # the initial state enters as the first step's additive term
        gated = torch.cat([gated[:, :1] + (a[:, 0] * h0)[:, None],
                           gated[:, 1:]], dim=1)
        hs = linear_scan(a, gated)
        new_cache = ({"conv": new_conv, "h": hs[:, -1]} if update_cache
                     else None)

    y = hs.to(x.dtype) * g
    return dense("out", y), new_cache
