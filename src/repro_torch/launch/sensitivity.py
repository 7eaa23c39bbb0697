"""Per-site quantization sensitivity sweep (PyTorch port of
``repro/launch/sensitivity.py``).

Which sites *deserve* higher precision?  Starting from a uniform-W4 plan
(every site int_sim, lm_head included), flip one site group back to float at
a time and measure logits-MSE against the full-float reference.  A large MSE
drop when a group is floated means that group's quantization error dominates
-- it's a candidate for a float/w4a16 rule in a mixed plan.

Used by ``launch/serve.py --sweep`` (the per-site table in the serve JSON
report).  Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ..configs import Runtime
from ..configs.base import ArchConfig
from ..models.transformer import forward, init_model
from ..serving.engine import resolve_device


def default_groups(cfg: ArchConfig) -> Sequence[str]:
    groups = ["attn.qkv", "attn.wo", "ffn.*", "lm_head", "block[0].*"]
    if cfg.n_layers > 1:
        groups.append(f"block[{cfg.n_layers - 1}].*")
    return groups


#: uniform-plan specs for the backend-comparison table: each serving GEMM
#: backend at its native activation precision (w4a16 keeps the activation
#: dtype; the W4A4 family quantizes per token).
COMPARE_BACKENDS: Dict[str, str] = {
    "int_sim": "*=int_sim",
    "lut4": "*=lut4",
    "w4a16": "*=w4a16/a16",
}


def sensitivity_sweep(cfg: ArchConfig, *,
                      groups: Optional[Sequence[str]] = None,
                      base_backend: str = "int_sim",
                      batch: int = 2, seq: int = 16, seed: int = 0,
                      params: Optional[Dict] = None,
                      tokens: Optional[torch.Tensor] = None,
                      device="cuda") -> Dict:
    """Per-site-group logits-MSE table vs the uniform-W4 plan.

    Returns ``{"uniform_mse_vs_float": ..., "per_site": [{"site",
    "mse_vs_float", "delta_vs_uniform"}, ...]}`` -- delta > 0 means floating
    that group removes that much of the uniform plan's quantization error.
    Also emits ``"backends"``: uniform-plan logits-MSE for every entry in
    ``COMPARE_BACKENDS`` (identical integer math makes the int_sim and lut4
    rows equal -- a drift between them is a kernel bug, not a quantization
    choice).

    `params` (float masters) and `tokens` ([batch, seq] ids) default to
    draws from a generator seeded with `seed` on `device`: the parameters
    first, then the tokens.
    """
    groups = list(groups) if groups is not None else list(default_groups(cfg))
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    if params is None:
        params = init_model(gen, cfg)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                               device=gen.device, dtype=torch.int32)
    batch, seq = tokens.shape
    rt0 = Runtime(attn_impl="chunked", attn_chunk_q=min(512, seq))

    @torch.no_grad()
    def logits_for(**rt_kw) -> torch.Tensor:
        rt = dataclasses.replace(rt0, **rt_kw)
        out = forward(params, tokens, cfg, rt)[0]
        return out.to(torch.float32)[..., :cfg.vocab]

    ref = logits_for(quant_backend="float")

    def mse(spec: str) -> float:
        diff = logits_for(quant_plan=spec) - ref
        return float(torch.mean(diff * diff))

    # uniform baseline quantizes *everything*, lm_head included, so the
    # head's own sensitivity is measurable
    uniform_spec = f"*={base_backend}"
    mse_u = mse(uniform_spec)

    rows = []
    for g in groups:
        m = mse(f"{g}=float;{uniform_spec}")
        rows.append({"site": g, "mse_vs_float": m,
                     "delta_vs_uniform": mse_u - m})
    rows.sort(key=lambda r: -r["delta_vs_uniform"])
    backend_rows = []
    for be, spec in COMPARE_BACKENDS.items():
        m = mse_u if spec == uniform_spec else mse(spec)
        backend_rows.append({"backend": be, "plan": spec,
                             "mse_vs_float": m})
    return {
        "arch": cfg.name,
        "base_backend": base_backend,
        "batch": batch, "seq": seq,
        "uniform_mse_vs_float": mse_u,
        "per_site": rows,
        "backends": backend_rows,
    }
