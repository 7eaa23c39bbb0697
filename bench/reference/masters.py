"""The model's float32 masters, drawn from the run's seed on the device.

Plain PyTorch: the harness hands these tensors to the program's packing,
and the reference draws the same tensors again, layer by layer, so that
neither side takes anything the other has made.  Each layer has a generator
of its own (`layer_seed`), so a layer can be drawn without drawing the
layers before it.  The leaves carry the names the program's parameter tree
uses; a leaf is drawn in one call, in float32 (the precision its int4 codes
and scales are derived from).

Weights are N(0, 1/fan_in).  Norm weights are 1 + N(0, NORM_STD^2) and the
biases N(0, BIAS_STD^2), so the comparison that decides `correct` also sees
the norms' weights and the biases: the published models carry trained
values there, never all ones or zeros.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

NORM_STD = 0.05
BIAS_STD = 0.02
#: the generator stream of the embedding, the final norm and the lm_head
GLOBALS = -1


def dims(model: Dict) -> Dict:
    """The shapes the masters take, from a configuration file's "model"
    section (its keys are those of the published config.json)."""
    D = model["hidden_size"]
    H = model["num_attention_heads"]
    # StarCoder2's ``use_bias`` puts a bias on every projection; the keys
    # below, where given, name the projections one by one
    every = model.get("use_bias") is True
    if model.get("o_proj_bias", every):
        raise NotImplementedError("a bias on the attention's output "
                                  "projection")
    return {
        "D": D, "H": H, "KV": model["num_key_value_heads"],
        "hd": model.get("head_dim") or D // H,
        "F": model["intermediate_size"], "V": model["vocab_size"],
        "L": model["num_hidden_layers"],
        "gated": model["hidden_act"] == "silu",
        "qkv_bias": bool(model.get("qkv_bias", every)),
        "mlp_bias": bool(model.get("mlp_bias", every)),
    }


def layer_seed(seed: int, layer: int) -> int:
    """A 63-bit generator seed for `layer` (GLOBALS for the embedding and
    the head) of run `seed`; any whole `seed` of up to 64 bits."""
    return (int(seed) * 1_000_003 + layer + 2) % (2 ** 63 - 1)


def _gen(seed: int, layer: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(layer_seed(seed, layer))


def _normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=g, device=g.device,
                       dtype=torch.float32) * std


def _norm_weight(g: torch.Generator, n: int) -> torch.Tensor:
    return 1.0 + _normal(g, (n,), NORM_STD)


def draw_globals(model: Dict, seed: int, device) -> Dict:
    """{"embed": [V, D], "final_norm": [D], "lm_head": [D, V]}."""
    d = dims(model)
    g = _gen(seed, GLOBALS, device)
    D, V = d["D"], d["V"]
    return {"embed": _normal(g, (V, D), 1 / math.sqrt(D)),
            "final_norm": _norm_weight(g, D),
            "lm_head": _normal(g, (D, V), 1 / math.sqrt(D))}


def draw_block(model: Dict, seed: int, layer: int, device) -> Dict:
    """Layer `layer`'s attention + FFN block, in the program's leaf names:
    ``norm1``, ``attn`` {wq, wk, wv, wo[, wq_bias, wk_bias, wv_bias]},
    ``norm2``, ``ffn`` {w_in, w_out[, w_gate][, b_in, b_out]}; weights
    are [in, out]."""
    d = dims(model)
    g = _gen(seed, layer, device)
    D, H, KV, hd, F = d["D"], d["H"], d["KV"], d["hd"], d["F"]
    attn = {"wq": _normal(g, (D, H * hd), 1 / math.sqrt(D)),
            "wk": _normal(g, (D, KV * hd), 1 / math.sqrt(D)),
            "wv": _normal(g, (D, KV * hd), 1 / math.sqrt(D)),
            "wo": _normal(g, (H * hd, D), 1 / math.sqrt(H * hd))}
    if d["qkv_bias"]:
        attn["wq_bias"] = _normal(g, (H * hd,), BIAS_STD)
        attn["wk_bias"] = _normal(g, (KV * hd,), BIAS_STD)
        attn["wv_bias"] = _normal(g, (KV * hd,), BIAS_STD)
    ffn = {"w_in": _normal(g, (D, F), 1 / math.sqrt(D)),
           "w_out": _normal(g, (F, D), 1 / math.sqrt(F))}
    if d["gated"]:
        ffn["w_gate"] = _normal(g, (D, F), 1 / math.sqrt(D))
    if d["mlp_bias"]:
        ffn["b_in"] = _normal(g, (F,), BIAS_STD)
        ffn["b_out"] = _normal(g, (D,), BIAS_STD)
    return {"norm1": _norm_weight(g, D), "attn": attn,
            "norm2": _norm_weight(g, D), "ffn": ffn}
