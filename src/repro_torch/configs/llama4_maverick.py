"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Source: hf:meta-llama/Llama-4-Scout-17B-16E (assignment citation).
[unverified tier] — config used exactly as assigned; early-fusion multimodal
frontend is out of scope (text backbone only, per assignment).
Head dim 128, five query heads a KV head.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    rope="rope",
    rope_theta=500000.0,
    n_experts=128,
    top_k=1,
    d_ff_expert=8192,
    shared_expert=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E [unverified]",
    notes="top-1 routing + always-on shared expert (early-fusion stubbed)",
)
