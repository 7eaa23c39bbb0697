"""Optimizer: AdamW with global-norm clipping, and the LR schedule."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm  # noqa: F401
from .schedule import warmup_cosine  # noqa: F401
