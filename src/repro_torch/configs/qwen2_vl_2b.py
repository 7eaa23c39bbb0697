"""qwen2-vl-2b [vlm] — M-RoPE, GQA kv=2, tied embeddings.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
Source: arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B. [hf tier]
The vision frontend is a stub, as in the JAX package: the model takes
token ids and 3-stream M-RoPE position ids (temporal/height/width); for
pure text the three streams coincide.  head_dim=128 => mrope_sections
(16, 24, 24) over 64 frequency slots.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope="mrope",
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B [hf]",
    notes="vision frontend stubbed (DESIGN.md §4)",
)
