"""qwen3-4b [dense] — GQA + qk_norm.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
Source: hf:Qwen/Qwen3-4B (per-assignment citation hf:Qwen/Qwen3-8B). [hf tier]
The lm_head is untied, as in the JAX package's config (``tie_embeddings``
stays False).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope="rope",
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B [hf]",
)
