"""internlm2-20b [dense] — GQA.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
Source: arXiv:2403.17297; hf:internlm/internlm2-20b. [hf tier]
Head dim 6144 / 48 = 128.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    rope="rope",
    rope_theta=1000000.0,
    source="arXiv:2403.17297; hf:internlm/internlm2-20b [hf]",
)
