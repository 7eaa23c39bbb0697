"""arctic-480b [moe] — 128 experts top-2 in parallel with a dense residual MLP.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
Source: hf:Snowflake/snowflake-arctic-base. [hf tier]
Arctic's dense-MoE hybrid: every layer = attention + (dense FFN || MoE FFN).
Head dim 7168 / 56 = 128, seven query heads a KV head.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    rope="rope",
    n_experts=128,
    top_k=2,
    d_ff_expert=4864,
    moe_dense_ff=4864,
    source="hf:Snowflake/snowflake-arctic-base [hf]",
    notes="dense-residual + top-2 MoE per layer",
)
