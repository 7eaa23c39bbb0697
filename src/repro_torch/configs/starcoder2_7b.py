"""starcoder2-7b [dense] — GQA kv=4, RoPE, GELU MLP with biases.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
Source: arXiv:2402.19173; hf:bigcode/starcoder2-7b. [hf tier]
Head dim 4608 / 36 = 128, nine query heads a KV head.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    ffn_type="gelu",
    qkv_bias=True,
    mlp_bias=True,
    rope="rope",
    rope_theta=1000000.0,
    source="arXiv:2402.19173; hf:bigcode/starcoder2-7b [hf]",
)
