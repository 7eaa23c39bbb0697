"""PyTorch + CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package (``src/repro``) is the reference; this package mirrors its
module layout (``repro/kernels/paged_attention.py`` maps to
``repro_torch/kernels/paged_attention.py``) and never imports it or JAX.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
