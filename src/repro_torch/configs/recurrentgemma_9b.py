"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 ratio.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
Source: arXiv:2402.19427 (Griffin) / RecurrentGemma. [unverified tier]
Pattern (R, R, A) x 12 + (R, R) tail = 38 layers, 26 recurrent : 12
attention.  Local window 2048: the attention cache is a ring of
min(max_ctx, 2048) slots a row.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    rope="rope",
    pattern=("R", "R", "A"),
    tail=("R", "R"),
    local_window=2048,
    lru_width=4096,
    ssm_conv=4,
    source="arXiv:2402.19427 [unverified]",
    notes="RG-LRU width 4096; MQA local attention window 2048",
)
