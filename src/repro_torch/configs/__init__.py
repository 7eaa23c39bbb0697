"""Architecture registry: every config of the JAX package (its ten), each
copied field for field from ``repro/configs/`` with its public source in its
docstring: qwen2-0.5b, qwen3-4b, qwen2-vl-2b, internlm2-20b, starcoder2-7b
and musicgen-large (dense attention, the paged layout), arctic-480b and
llama4-maverick (MoE "A" blocks; paged),
mamba2-130m (SSM) and recurrentgemma-9b (hybrid; both through the
contiguous layout).  Select with ``--arch <name>``."""

from __future__ import annotations

from typing import Dict

from .arctic_480b import CONFIG as _arctic
from .base import (ArchConfig, Runtime, SHAPES, ServingConfig,  # noqa: F401
                   Shape, runnable)
from .internlm2_20b import CONFIG as _internlm2
from .llama4_maverick import CONFIG as _llama4
from .mamba2_130m import CONFIG as _mamba2
from .musicgen_large import CONFIG as _musicgen
from .qwen2_0_5b import CONFIG as _qwen2_05
from .qwen2_vl_2b import CONFIG as _qwen2_vl
from .qwen3_4b import CONFIG as _qwen3
from .recurrentgemma_9b import CONFIG as _rgemma
from .starcoder2_7b import CONFIG as _starcoder2

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in [_musicgen, _mamba2, _qwen3, _internlm2, _starcoder2,
                        _qwen2_05, _llama4, _arctic, _qwen2_vl, _rgemma]}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]
