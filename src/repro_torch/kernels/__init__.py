"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions;
``kernels.ops`` dispatches between them by tensor device."""
