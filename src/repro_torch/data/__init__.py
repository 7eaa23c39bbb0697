"""Data pipeline: the deterministic synthetic token stream."""
from .synthetic import SyntheticLMDataset, make_batch_iterator  # noqa: F401
