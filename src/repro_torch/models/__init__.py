"""Decoder LM (dense attention + SwiGLU FFN) over the quantized linear."""
