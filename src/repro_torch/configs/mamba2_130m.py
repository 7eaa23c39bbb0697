"""mamba2-130m [ssm] — attention-free SSD (state-space duality).

24L d_model=768 d_ff=0 vocab=50280 ssm_state=128.
Source: arXiv:2405.21060 (Mamba-2). [unverified tier]
d_inner=2*768=1536, headdim=64 => 24 SSD heads, 1 group. Pure mamba blocks
(no separate FFN; d_ff=0). Sub-quadratic => runs long_500k.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,            # unused (attention-free); kept for interface
    n_kv_heads=12,
    d_ff=0,
    vocab=50280,
    rope="none",
    tie_embeddings=True,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
    ssm_chunk=128,
    pattern=("M",),
    source="arXiv:2405.21060 [unverified]",
    notes="vocab padded 50280->50304 for TP divisibility (GPT-NeoX-style)",
)
