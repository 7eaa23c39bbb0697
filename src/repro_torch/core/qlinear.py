"""QuantizedLinear (PyTorch port of ``repro/core/qlinear.py``).

Every projection routes through `qdense`.  The backend comes from
`QuantConfig.backend` out of the registry in `core.backends`; pre-packed
serving weights (``{"packed", "scale", "packed_km"}`` dicts from
`quant_plan.pack_for_serving`) take the packed path.  Ported here:

  float       -- plain GEMM in the activation dtype
  int_sim     -- W4A4 from a float master: the weight is quantized and
                 packed K-major per call, the GEMM is the fused W4A4 kernel
                 (``kernels.ops.int4_matmul_fused_kmajor``: the CUDA kernel
                 on CUDA tensors, its plain version on CPU tensors)
  w4a4_packed -- pre-packed int4 weights through the fused W4A4 kernel

The W4A4 integer math is exact, so all of these equal the JAX package's
int_sim numerics.  fake_quant, w4a16, lut4 and netlist wait for later
slices and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels import ops
from ..kernels.packing import nmajor_to_kmajor
from .quant import pack_int4, quant_scale, quantize


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    backend: str = "fake_quant"     # float | int_sim | w4a4_packed | ...
    w_bits: int = 4
    a_bits: int = 4
    group_size: int = 0             # 0 => per-output-channel scales
    quantize_embedding: bool = False

    @property
    def quantized(self) -> bool:
        return self.backend != "float"


#: backends whose packed weights run the W4A4 integer GEMM
W4A4_BACKENDS = ("w4a4_packed", "int_sim")


def check_int4(cfg: QuantConfig, tag: str = "") -> None:
    """The W4A4 kernel takes 4-bit weights and activations only."""
    if cfg.w_bits != 4 or cfg.a_bits != 4:
        raise NotImplementedError(
            f"site {tag!r}: w{cfg.w_bits}a{cfg.a_bits} is not ported; only "
            f"the W4A4 GEMM is")


def qdense(w, x: torch.Tensor, cfg: QuantConfig,
           bias: Optional[torch.Tensor] = None, tag: str = "") -> torch.Tensor:
    """Quantized dense layer; output dtype follows x.

    `w` is a float master [K, N] or a pre-packed serving weight.  The
    wrapper owns batch flattening, the bias add and the output cast; the
    per-backend GEMMs live in `core.backends`."""
    from .backends import get_backend

    if isinstance(w, dict) and "packed" in w:
        fn = _packed_backend
    else:
        if cfg.backend == "w4a4_packed":
            # weight left unpacked (too small for the plan packer): the
            # equivalent on-the-fly path
            cfg = dataclasses.replace(cfg, backend="int_sim")
        fn = get_backend(cfg.backend)
    out_dtype = x.dtype
    lead = x.shape[:-1]
    y = fn(w, x.reshape(-1, x.shape[-1]), cfg, tag)
    y = y.reshape(*lead, y.shape[-1])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(out_dtype)


def _packed_backend(w, x2: torch.Tensor, cfg: QuantConfig, tag: str = ""):
    """Serving path for a pre-packed weight: W4A4 through the fused kernel
    on the planar K-major twin (`packed_km`, added by `prepack_tree`; made
    here when absent)."""
    packed, w_scale = w["packed"], w["scale"]
    if cfg.backend not in W4A4_BACKENDS:
        raise ValueError(
            f"packed weight at site {tag!r} reached backend {cfg.backend!r}, "
            f"which has no packed-weight path in this port")
    check_int4(cfg, tag)
    xf = x2.to(torch.float32)
    w_km = w.get("packed_km")
    if w_km is None:
        w_km = nmajor_to_kmajor(packed)
    return ops.int4_matmul_fused_kmajor(xf, w_km, w_scale)


#: linear-weight leaf names eligible for serving-side packing
PACKABLE_NAMES = frozenset({
    "wq", "wk", "wv", "wo",
    "w_in", "w_gate", "w_out",
    "in_proj", "out_proj",
    "in_x", "in_g", "w_a", "w_x", "out",
})


def pack_weight_nd(w: torch.Tensor, cfg: QuantConfig):
    """Pack a [..., K, N] float weight, nibbles packed along N (plain and
    layer-stacked weights alike).  Scales are per output channel
    [..., 1, N], or per group [..., K//G, 1, N] when `cfg.group_size`
    divides K."""
    K, N = w.shape[-2], w.shape[-1]
    g = cfg.group_size
    if g and 0 < g < K:
        assert K % g == 0, (K, g)
        wg = w.reshape(*w.shape[:-2], K // g, g, N)
        scale = quant_scale(wg, axis=-2, bits=cfg.w_bits)
        q = quantize(wg, scale, bits=cfg.w_bits).reshape(w.shape)
    else:
        scale = quant_scale(w, axis=-2, bits=cfg.w_bits)
        q = quantize(w, scale, bits=cfg.w_bits)
    return {"packed": pack_int4(q, axis=-1), "scale": scale}


def prepack_tree(params):
    """Add a planar K-major twin (`packed_km`) to every packed serving
    weight, once, so the kernel unpacks with a shift and a mask and no
    serving step relayouts a weight.  Grouped scales need planar halves that
    cover whole groups (row_mult = 2G); per-channel ones need 2."""
    def walk(node):
        if isinstance(node, dict) and "packed" in node:
            if "packed_km" in node:
                return node
            rm = 2
            if node["scale"].ndim == node["packed"].ndim + 1:
                rm = 2 * (node["packed"].shape[-2] // node["scale"].shape[-3])
            return {**node, "packed_km":
                    nmajor_to_kmajor(node["packed"], rm).contiguous()}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)
