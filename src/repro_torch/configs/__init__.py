"""Architecture registry.  The port serves qwen2-0.5b; the JAX package's
other nine configs come with the slices that port their mixers."""

from __future__ import annotations

from typing import Dict

from .base import ArchConfig, Runtime, ServingConfig  # noqa: F401
from .qwen2_0_5b import CONFIG as _qwen2_05

REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in [_qwen2_05]}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]

