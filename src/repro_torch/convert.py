"""Carry parameter trees between the JAX package and this port, and
between devices.

``params_from_jax`` takes the reference's parameter tree with its leaves
already turned into numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's tree: bf16 leaves go through float32 (numpy has no
native bf16; the JAX package's checkpoints do the same) and come back as
torch bf16, packed int4 dicts keep their uint8 bytes, every other leaf keeps
its dtype.  The port and the reference then compute on identical weights.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cuda"):
    """numpy-leaved reference tree -> torch tree on `device` (the card
    unless the caller asks for the CPU)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_to(tree, device):
    """Copy every tensor of a (nested dict / list) tree to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
