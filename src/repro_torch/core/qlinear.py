"""QuantizedLinear (PyTorch port of ``repro/core/qlinear.py``).

Every projection routes through `qdense`.  The backend comes from
`QuantConfig.backend` out of the registry in `core.backends`; pre-packed
serving weights (``{"packed", "scale", "packed_km"}`` dicts from
`quant_plan.pack_for_serving`) take the packed path.  Ported here:

  float        -- plain GEMM in the activation dtype
  fake_quant   -- QAT: straight-through fake-quant on weight and
                  activations, float GEMM
  int_sim,     -- W4A4 from a float master: the weight is quantized and
  pallas_int4     packed K-major per call, the GEMM is the fused W4A4
                  kernel (``kernels.ops.int4_matmul_fused_kmajor``)
  lut4         -- W4A4 through the table-lookup GEMM
                  (``kernels.ops.lut4_matmul_kmajor``): the same integers
  w4a16        -- weight-only int4 (per channel or per group), activations
                  in their dtype (``kernels.ops.w4a16_matmul_kmajor``)
  w4a4_packed  -- pre-packed int4 weights through the fused W4A4 kernel
  w4a16_packed -- pre-packed int4 weights (per-channel or grouped scales)
                  through the W4A16 kernel

Every kernel-backed GEMM takes the kernel route on every device: the CUDA
kernel on CUDA tensors, its plain version on CPU tensors.  The W4A4
integer math is exact, so the W4A4 backends equal the JAX package's
int_sim numerics; W4A16 equals the JAX package's XLA twin up to f32
summation order.  netlist is not ported and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels import ops
from ..kernels.packing import nmajor_to_kmajor_grouped
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


#: backends whose packed weights run a W4A4 integer GEMM
W4A4_BACKENDS = ("w4a4_packed", "int_sim", "pallas_int4", "lut4")


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
        if cfg.backend in ("w4a4_packed", "w4a16_packed"):
            # weight left unpacked (too small for the plan packer): the
            # equivalent on-the-fly path
            cfg = dataclasses.replace(
                cfg,
                backend="int_sim" if cfg.backend == "w4a4_packed" else "w4a16")
        fn = get_backend(cfg.backend)
    out_dtype = x.dtype
    lead = x.shape[:-1]
    y = fn(w, x.reshape(-1, x.shape[-1]), cfg, tag)
    y = y.reshape(*lead, y.shape[-1])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(out_dtype)


def _packed_backend(w, x2: torch.Tensor, cfg: QuantConfig, tag: str = ""):
    """Serving path for a pre-packed weight, on its planar K-major twin
    (`packed_km`, added by `prepack_tree`; made here when absent).  W4A4
    backends run the fused W4A4 kernel, ``lut4`` quantizes the activations
    and runs the table-lookup kernel, the W4A16 backends run the W4A16
    kernel with the scales' rank picking per-channel or grouped (the group
    size recovered from the scale's shape)."""
    packed, w_scale = w["packed"], w["scale"]
    w_km = w.get("packed_km")
    if w_km is None:
        w_km = nmajor_to_kmajor_grouped(packed, w_scale)
    if cfg.backend in W4A4_BACKENDS:
        check_int4(cfg, tag)
        xf = x2.to(torch.float32)
        if cfg.backend == "lut4":
            a_scale = quant_scale(xf, axis=1, bits=4)
            a_q = quantize(xf, a_scale, bits=4)
            return ops.lut4_matmul_kmajor(a_q, a_scale, w_km, w_scale)
        return ops.int4_matmul_fused_kmajor(xf, w_km, w_scale)
    if cfg.backend not in ("w4a16", "w4a16_packed"):
        raise ValueError(
            f"packed weight at site {tag!r} reached backend {cfg.backend!r}, "
            f"which has no packed-weight path")
    K = x2.shape[1]
    g = K // w_scale.shape[0] if w_scale.ndim == 3 else K
    return ops.w4a16_matmul_kmajor(x2, w_km, w_scale, g)


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
            return {**node, "packed_km": nmajor_to_kmajor_grouped(
                node["packed"], node["scale"]).contiguous()}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)
