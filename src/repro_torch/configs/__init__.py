"""Architecture registry: the configs the port serves, each copied field
for field from ``repro/configs/`` with its public source in its docstring:
qwen2-0.5b, qwen3-4b, qwen2-vl-2b and internlm2-20b (attention, the paged
layout), mamba2-130m (SSM) and recurrentgemma-9b (hybrid; both through the
contiguous layout).  The JAX package's other four (starcoder2-7b,
musicgen-large: ROADMAP Queue 1 item 2b; arctic-480b, llama4-maverick:
MoE, item 3) come with the slices that port their blocks."""

from __future__ import annotations

from typing import Dict

from .base import ArchConfig, Runtime, ServingConfig  # noqa: F401
from .internlm2_20b import CONFIG as _internlm2
from .mamba2_130m import CONFIG as _mamba2
from .qwen2_0_5b import CONFIG as _qwen2_05
from .qwen2_vl_2b import CONFIG as _qwen2_vl
from .qwen3_4b import CONFIG as _qwen3
from .recurrentgemma_9b import CONFIG as _rgemma

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in [_mamba2, _qwen3, _internlm2, _qwen2_05, _qwen2_vl,
                        _rgemma]}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]
