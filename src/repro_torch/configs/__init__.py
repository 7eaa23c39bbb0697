"""Architecture registry.  The port serves qwen2-0.5b, mamba2-130m and
recurrentgemma-9b; the JAX package's other seven configs come with the
slices that port their mixers."""

from __future__ import annotations

from typing import Dict

from .base import ArchConfig, Runtime, ServingConfig  # noqa: F401
from .mamba2_130m import CONFIG as _mamba2
from .qwen2_0_5b import CONFIG as _qwen2_05
from .recurrentgemma_9b import CONFIG as _rgemma

REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in [_mamba2, _qwen2_05,
                                                       _rgemma]}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]

