"""Checkpoints: float trees and the quantized serving format, in the JAX
package's on-disk layout."""
from .ckpt import (  # noqa: F401
    CheckpointManager,
    QUANTIZED_FORMAT,
    latest_step,
    restore_checkpoint,
    restore_quantized,
    save_checkpoint,
    save_quantized,
)
