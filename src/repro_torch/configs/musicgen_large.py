"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (kv=32 => full MHA) d_ff=8192 vocab=2048.
Source: arXiv:2306.05284 (MusicGen); hf:facebook/musicgen-large. [hf tier]
Modality frontend (EnCodec + delay-pattern interleaving + text conditioning)
is a STUB per the assignment: input_specs() provides token ids directly.
Positional encoding: non-learned sinusoidal (rope="none").
Head dim 2048 / 32 = 64, one query head a KV head; the vocab, 2048, is
already a multiple of 128 (``vocab_padded`` == 2048), the lm_head untied.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="dense",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    ffn_type="gelu",
    rope="none",
    source="arXiv:2306.05284; hf:facebook/musicgen-large [hf]",
    notes="audio backbone; EnCodec frontend stubbed (DESIGN.md §4)",
)
