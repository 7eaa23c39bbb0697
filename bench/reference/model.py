"""Plain PyTorch reference of the served decoder: W4A4 projections, RMSNorm,
RoPE, causal GQA attention, a SwiGLU or GELU FFN and a float lm_head.

It follows the configuration file's "model" section and nothing of the
program: the masters come again from `masters.py` (the run's seed), the
weights' int4 codes and per-channel scales and the activations' per-row
int4 codes are worked out here.  The integer products run as float32
matmuls of the codes: every partial sum is an integer under 2**24, so they
are exact in any order.  Everything else is float32 with TF32 off.

`act` rounds every tensor the served program stores in its activation
dtype (bfloat16) to a lower precision at the same places: the control of
the comparison.  None keeps float32 throughout (the reference itself).

Teacher-forced: one forward over each prompt and its served tokens, layer
by layer over all the sequences, each layer's masters drawn, used and
freed before the next, so that the reference holds one layer at a time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .masters import dims, draw_block, draw_globals

FP8_MAX = 448.0


def fp32_matmuls() -> None:
    """Float32 matmuls in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rounder(act: Optional[torch.dtype]):
    """x -> x rounded to `act` and back to float32 (fp8 saturates at its
    largest finite value); None leaves x as it is."""
    if act is None:
        return lambda x: x
    if act == torch.float8_e4m3fn:
        return lambda x: x.clamp(-FP8_MAX, FP8_MAX).to(act).to(torch.float32)
    return lambda x: x.to(act).to(torch.float32)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 7, the quotient rounded once: the divisor is a tensor, since
    CUDA divides by a Python number through its reciprocal, which can land
    one ulp away and move a code that sits on a tie."""
    return amax / amax.new_full((), 7.0)


def int4_rows(x: torch.Tensor):
    """Symmetric int4 codes of x [..., K] per row: (codes as float32,
    scales [..., 1]), scale = amax / 7, round half to even, clip to
    [-8, 7]."""
    s = _scale(x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8))
    return torch.clamp(torch.round(x / s), -8.0, 7.0), s


def int4_cols(w: torch.Tensor):
    """Per-output-channel int4 codes of w [K, N]: (codes, scales [1, N])."""
    s = _scale(w.abs().amax(dim=0, keepdim=True).clamp_min(1e-8))
    return torch.clamp(torch.round(w / s), -8.0, 7.0), s


def w4a4(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None):
    """x [T, K] float32 times w = int4_cols(master): the rows' int4 codes
    dotted with the weight's, then both scales (and the bias)."""
    wq, ws = w
    xq, xs = int4_rows(x)
    y = (xq @ wq) * xs * ws
    return y if bias is None else y + bias


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on the two halves of each head: x [T, n, hd]."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = pos[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def attention(q, k, v, window: int) -> torch.Tensor:
    """Causal GQA over one sequence: q [T, H, hd] at the last T of the
    S >= T positions of k/v [S, KV, hd]; a key is seen when it is at or
    before the query (and, with a window, fewer than `window` positions
    back)."""
    T, H, hd = q.shape
    S, KV = k.shape[0], k.shape[1]
    qg = q.reshape(T, KV, H // KV, hd)
    scores = torch.einsum("tkgh,skh->kgts", qg, k) / math.sqrt(hd)
    t = torch.arange(T, device=q.device)[:, None] + (S - T)
    s = torch.arange(S, device=q.device)[None, :]
    seen = s <= t
    if window:
        seen &= (t - s) < window
    scores = scores.masked_fill(~seen, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("kgts,skh->tkgh", probs, v).reshape(T, H * hd)


def _window(model: Dict) -> int:
    return int(model.get("sliding_window") or 0)


def attn_in(x, p, d, model, pos, rnd):
    """The attention's inputs for rows x [N, D] at positions pos [N]:
    q [N, H, hd] and k, v [N, KV, hd], rotated, as the pool stores them."""
    if model.get("norm_type", "rms_norm") != "rms_norm":
        raise NotImplementedError(f"norm_type {model['norm_type']}")
    theta = float(model["rope_theta"])
    N = x.shape[0]
    a = p["attn"]
    h = rnd(rms_norm(x, p["norm1"], model_eps(model)))
    q = rnd(w4a4(h, a["wq"], a.get("wq_bias")))
    k = rnd(w4a4(h, a["wk"], a.get("wk_bias")))
    v = rnd(w4a4(h, a["wv"], a.get("wv_bias")))
    q = rnd(rope(q.reshape(N, d["H"], d["hd"]), pos, theta))
    k = rnd(rope(k.reshape(N, d["KV"], d["hd"]), pos, theta))
    return q, k, v.reshape(N, d["KV"], d["hd"])


def attn_out(o, p, rnd):
    """The output projection of the attention's rows o [N, H * hd]."""
    return rnd(w4a4(o, p["attn"]["wo"]))


def ffn_part(x, p, d, model, rnd):
    """The FFN half of a block over rows x [N, D]: its output before the
    residual."""
    f = p["ffn"]
    h = rnd(rms_norm(x, p["norm2"], model_eps(model)))
    up = rnd(w4a4(h, f["w_in"], f.get("b_in")))
    if d["gated"]:
        g = rnd(w4a4(h, f["w_gate"]))
        mid = rnd(g * torch.sigmoid(g) * up)
    else:
        mid = rnd(gelu_tanh(up))
    return rnd(w4a4(mid, f["w_out"], f.get("b_out")))


def block(x, p, d, model, pos, rnd):
    """One attention + FFN block over one sequence x [T, D]."""
    q, k, v = attn_in(x, p, d, model, pos, rnd)
    o = rnd(attention(q, k, v, _window(model)))
    x = rnd(x + attn_out(o, p, rnd))
    return rnd(x + ffn_part(x, p, d, model, rnd))


def head(x, final_norm, lm_head, model, rnd):
    """Logits of rows x [N, D] (the last block's output)."""
    h = rnd(rms_norm(x, final_norm, model_eps(model)))
    return rnd(h @ lm_head)


def model_eps(model: Dict) -> float:
    return float(model.get("rms_norm_eps", model.get("norm_epsilon", 1e-6)))


def quantized(p: Dict) -> Dict:
    """The block's masters with every weight matrix as (int4 codes,
    scales); norms and biases as they are."""
    out: Dict = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = quantized(v)
        elif v.dim() == 2:
            out[k] = int4_cols(v)
        else:
            out[k] = v
    return out


@torch.no_grad()
def kv_layer0(model: Dict, seed: int, seqs: List[torch.Tensor],
              act: Optional[torch.dtype] = None, device="cuda"):
    """Layer 0's keys (rotated) and values [T, KV, hd] of each sequence:
    the start of the forward, where no earlier rounding has been
    amplified."""
    fp32_matmuls()
    d = dims(model)
    rnd = rounder(act)
    embed = draw_globals(model, seed, device)["embed"]
    p = quantized(draw_block(model, seed, 0, device))
    out = []
    for s in seqs:
        _, k, v = attn_in(rnd(embed[s]), p, d, model,
                          torch.arange(len(s), device=device), rnd)
        out.append((k, v))
    return out


@torch.no_grad()
def logits_at(model: Dict, seed: int, seqs: List[torch.Tensor],
              rows: List[torch.Tensor], act: Optional[torch.dtype] = None,
              device="cuda") -> List[torch.Tensor]:
    """Float32 logits [len(rows[i]), V] of sequence i (token ids, int64)
    at positions rows[i], each from the tokens up to and including it."""
    fp32_matmuls()
    d = dims(model)
    rnd = rounder(act)
    glob = draw_globals(model, seed, device)
    xs = [rnd(glob["embed"][s]) for s in seqs]
    lm_head, final_norm = glob["lm_head"], glob["final_norm"]
    del glob
    pos = [torch.arange(len(s), device=device) for s in seqs]
    for layer in range(d["L"]):
        p = quantized(draw_block(model, seed, layer, device))
        xs = [block(x, p, d, model, ps, rnd) for x, ps in zip(xs, pos)]
        del p
    return [head(x[r], final_norm, lm_head, model, rnd)
            for x, r in zip(xs, rows)]
