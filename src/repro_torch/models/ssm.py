"""Mamba-2 (SSD, state-space duality) block, chunked (PyTorch port of
``repro/models/ssm.py``).

Projections (`in_proj`, `out_proj`) go through the quantized linear, so
under ``--quant w4a4_packed`` they run the fused W4A4 GEMM; the recurrent
state stays float32.  The depthwise causal convolution is K shifted adds
in the JAX package's order, and the SSD einsums are PyTorch ops, as they
are XLA ops (outside Pallas) in the JAX package.

Where the JAX package combines the chunks' states with
``lax.associative_scan`` (log depth), this port runs the carry as a loop
over chunks, ``h_c = h_{c-1} * exp(sum of the chunk's dA) + S_c``: the
same recurrence in float32, its sums in another order.

Caches are ``{"conv": [B, K-1, conv_dim] f32, "ssd": [B, H, P, N] f32}``;
a step returns a new cache dict (the JAX package's functional update).

Under a mesh ``in_proj`` is column-parallel and ``out_proj`` row-parallel
where the rules shard them; the projection is made whole between them, so
the convolution and the scan run on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.quant_plan import join_site
from ..distributed.tensor_parallel import (column_dense, gather_columns,
                                           row_dense)
from .common import normal_init, rms_norm


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg) -> Dict:
    D, di, N, H, G = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_groups)
    cd, dev = conv_dim(cfg), gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": normal_init(gen, (D, 2 * di + 2 * G * N + H)),
        "conv_w": normal_init(gen, (cfg.ssm_conv, cd), fan_in=cfg.ssm_conv),
        "conv_b": torch.zeros((cd,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, H,
                                                        **f32))),
        "norm_w": torch.ones((di,), **f32),
        "out_proj": normal_init(gen, (di, D), fan_in=di),
    }


def init_mamba_cache(cfg, batch: int, device="cuda") -> Dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)), **f32),
        "ssd": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                            cfg.ssm_state), **f32),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * logistic(x), logistic = 1 / (1 + exp(-x)), each op rounding to
    x's dtype, as the JAX package's XLA path evaluates it."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width K, as K shifted adds in order.  xBC
    [B, S, C]; w [K, C]; conv_state [B, K-1, C] or None.  Returns (y
    [B, S, C], new conv state [B, K-1, C] f32)."""
    K = w.shape[0]
    if conv_state is None:
        pad = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
    else:
        pad = conv_state.to(xBC.dtype)
    full = torch.cat([pad, xBC], dim=1)                         # [B, S+K-1, C]
    S = xBC.shape[1]
    y = full[:, 0:S] * w[0][None, None, :]
    for k in range(1, K):
        y = y + full[:, k:k + S] * w[k][None, None, :]
    new_state = full[:, full.shape[1] - (K - 1):]
    return y + b[None, None, :], new_state.to(torch.float32)


def apply_mamba(params: Dict, x: torch.Tensor, cfg, rt,
                cache: Optional[Dict] = None, update_cache: bool = False,
                site: str = "mamba") -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B, S, D] -> (y [B, S, D], new cache or None).  With a cache and
    S == 1: one recurrence step; otherwise the chunked SSD from the cache's
    state (zeros without a cache), its final state returned with
    `update_cache`."""
    B, S, _ = x.shape
    di, N, H, P_, G = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_headdim, cfg.ssm_groups)
    cd = conv_dim(cfg)
    s_in = join_site(site, "in_proj")
    n_in = 2 * di + 2 * G * N + H
    proj, sh = column_dense(params["in_proj"], x, rt.quant_cfg(cfg, s_in),
                            tag=s_in, n_out=n_in)
    # the projection's columns cut across z, xBC and dt: the mixer runs on
    # the whole projection, on every rank
    proj = gather_columns(proj, sh)
    z = proj[..., :di]
    xBC = proj[..., di:di + cd]
    dt = proj[..., di + cd:]

    conv_state = cache["conv"] if cache is not None else None
    xBC, new_conv = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                 conv_state)
    xBC = _silu(xBC)

    xs = xBC[..., :di].reshape(B, S, H, P_)
    Bm = xBC[..., di:di + G * N].reshape(B, S, G, N)
    Cm = xBC[..., di + G * N:].reshape(B, S, G, N)
    # each group's B and C repeated for its H // G heads (jnp.repeat)
    Bm = Bm[:, :, :, None].expand(B, S, G, H // G, N).reshape(B, S, H, N)
    Cm = Cm[:, :, :, None].expand(B, S, G, H // G, N).reshape(B, S, H, N)

    dt = dt.to(torch.float32) + params["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))              # softplus
    A = -torch.exp(params["A_log"])                             # [H]
    dA = dt * A                                                 # [B, S, H]
    f32 = torch.float32

    if cache is not None and S == 1:
        # ---- decode: one recurrence step --------------------------------
        h = cache["ssd"]                                        # [B,H,P,N]
        dBx = (dt[:, 0, :, None, None] * Bm[:, 0, :, None, :].to(f32)
               * xs[:, 0, :, :, None].to(f32))
        h = torch.exp(dA[:, 0])[:, :, None, None] * h + dBx
        y = torch.einsum("bhn,bhpn->bhp", Cm[:, 0].to(f32), h)
        y = y + params["D"][None, :, None] * xs[:, 0].to(f32)
        y = y[:, None].to(x.dtype)                              # [B,1,H,P]
        new_cache = {"conv": new_conv, "ssd": h}
    else:
        # ---- chunked SSD ------------------------------------------------
        Q = min(cfg.ssm_chunk, S)
        pad = (-S) % Q
        if pad:
            def padt(t):
                return torch.cat([t, t.new_zeros((B, pad) + t.shape[2:])],
                                 dim=1)
            xs, Bm, Cm, dA, dt = (padt(t) for t in (xs, Bm, Cm, dA, dt))
        Sp = S + pad
        nc = Sp // Q
        xs_c = xs.reshape(B, nc, Q, H, P_).to(f32)
        B_c = Bm.reshape(B, nc, Q, H, N).to(f32)
        C_c = Cm.reshape(B, nc, Q, H, N).to(f32)
        dA_c = dA.reshape(B, nc, Q, H)
        dt_c = dt.reshape(B, nc, Q, H)

        l = torch.cumsum(dA_c, dim=2)                           # [B,nc,Q,H]
        l_last = l[:, :, -1:, :]
        xdt = xs_c * dt_c[..., None]

        # intra-chunk, masked causal.  The mask goes BEFORE the exp: above
        # the diagonal l_i - l_j >> 0 and exp overflows to inf (inf * 0 =
        # NaN) if masked after
        diff = l[:, :, :, None] - l[:, :, None, :, :]            # [B,nc,Q,Q,H]
        tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                    device=x.device))[None, None, :, :, None]
        decay = torch.exp(torch.where(tri, diff, float("-inf")))
        scores = torch.einsum("bcqhn,bckhn->bcqkh", C_c, B_c) * decay
        y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xdt)

        # chunk summaries, then the inter-chunk carry in chunk order
        w = torch.exp(l_last - l)                               # [B,nc,Q,H]
        S_c = torch.einsum("bcqhn,bcqhp->bchpn", B_c * w[..., None], xdt)
        d_c = torch.exp(l_last[:, :, 0, :])                     # [B,nc,H]
        h0 = (cache["ssd"] if cache is not None
              else torch.zeros((B, H, P_, N), dtype=f32, device=x.device))
        h, after = h0, []
        for c in range(nc):
            h = h * d_c[:, c, :, None, None] + S_c[:, c]
            after.append(h)
        h_after = torch.stack(after, dim=1)                     # [B,nc,H,P,N]
        h_before = torch.cat([h0[:, None], h_after[:, :-1]], dim=1)

        y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                               C_c * torch.exp(l)[..., None], h_before)
        y = y_intra + y_inter + params["D"][None, None, None, :, None] * xs_c
        y = y.reshape(B, Sp, H, P_)[:, :S].to(x.dtype)
        new_cache = None
        if update_cache:
            new_cache = {"conv": new_conv, "ssd": h_after[:, -1]}

    y = y.reshape(B, S, di)
    y = rms_norm(y * _silu(z), params["norm_w"], cfg.norm_eps)
    s_out = join_site(site, "out_proj")
    out = row_dense(params["out_proj"], y, rt.quant_cfg(cfg, s_out),
                    tag=s_out, k_in=di)
    return out, new_cache
