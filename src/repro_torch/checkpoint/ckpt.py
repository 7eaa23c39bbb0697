"""Atomic checkpoints of torch trees in the JAX package's on-disk format
(PyTorch port of ``repro/checkpoint/ckpt.py``).

Layout:  <dir>/step_<N>/
             manifest.json   (step, time, process count, keys, shapes,
                              dtypes, and any extra metadata)
             shard_<p>.npz   (one file a process; this port saves from one
                              process, so shard_0 alone, and restores every
                              shard the manifest counts)

Keys are the tree's paths joined by ``/`` (dict keys sorted at every level,
as ``jax.tree_util`` flattens them; a list's index is its key); npz has no
bf16, so bf16 leaves are stored as float32 (exact) with ``"bfloat16"`` in
the manifest's ``dtypes``.  A checkpoint written by either package restores
in the other.  Dtype names map to torch dtypes here (`_TORCH_DTYPES`): the
port never asks numpy for a bf16 array.

  * **atomicity** -- a save writes ``step_<N>.tmp_<uuid>`` and then
    ``os.replace``\\ s it into place, so a crash mid-save never corrupts the
    latest checkpoint;
  * **resume-from-latest** -- `latest_step` returns the newest step with a
    manifest and removes partial ``.tmp_`` saves;
  * **retention** -- `CheckpointManager` keeps the last ``keep`` steps.

Leaves derived from others never reach the disk: the planar K-major twins
(``packed_km``, added by ``core.qlinear.prepack_tree``) and the per-block
views (``"layer_views"``, ``models.transformer.with_layer_views``).
`restore_quantized` rebuilds the twins when it places the tree on CUDA.

A quantized checkpoint (`save_quantized`, manifest ``format`` =
`QUANTIZED_FORMAT`) holds the tree ``quant_plan.plan_pack_tree`` makes with
``CKPT_PACKED`` and bf16 scales, the plan, and the backend each packed site
was packed for; `restore_quantized` rebuilds the packed tree from the
manifest alone and checks the serving plan against both.  A plan that
packs layers differently keeps the JAX package's ``layers/r<r>/u<j>`` keys
on disk; in memory the port holds those blocks as a list.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np
import torch

#: manifest tag of serving-ready packed checkpoints
QUANTIZED_FORMAT = "quantized-v1"
#: leaves rebuilt from others, never stored
DERIVED_KEYS = frozenset({"packed_km", "layer_views"})
#: manifest dtype names -> torch dtypes
_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} in the order ``jax.tree_util`` flattens the same tree:
    dict keys sorted at every level, list items in order; derived leaves
    and None are left out."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree) if k not in DERIVED_KEYS]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    elif tree is None:
        return out
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten_like(like, leaves: Dict[str, Any], prefix: str = ""):
    """`like`'s structure (without its derived leaves) with the leaves of
    `leaves` by path."""
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}/{k}" if prefix
                                   else str(k))
                for k, v in like.items() if k not in DERIVED_KEYS}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves, f"{prefix}/{i}"
                                          if prefix else str(i))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaves[prefix]


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array the npz stores: bf16 as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _DTYPE_NAMES[leaf.dtype]
    return np.asarray(leaf).dtype.name


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"checkpoint dtype {name!r} has no torch "
                         "counterpart") from None


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra_meta: Optional[Dict] = None,
                    shardings: Optional[Any] = None) -> str:
    """Atomic save of `tree` (nested dicts and lists of tensors) as step
    `step`.  A step already on disk is kept as it is (the JAX package
    writes the new copy and then discards it; the result is the same).
    With `shardings` (a ``NamedSharding`` tree: `tree` holds this rank's
    shards) every rank of the mesh must call it: the leaves are gathered
    whole, rank 0 writes, and every rank waits for the write.  Returns the
    checkpoint's path."""
    final = os.path.join(directory, f"step_{step:08d}")
    if shardings is not None:
        from ..distributed.sharding import tree_full

        full = tree_full(_strip(tree), shardings)
        if _rank() == 0:
            save_checkpoint(directory, step, full, extra_meta)
        _barrier()
        return final
    if os.path.exists(final):
        return final
    tmp = final + f".tmp_{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        dtypes[k] = _dtype_name(v)
        arrays[k] = _to_numpy(v)
    # one process saves everything (multi-process saves wait for the
    # distributed layer): shard 0 of a process count of 1
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "process_count": 1,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": dtypes,
    }
    manifest.update(extra_meta or {})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under `directory` (None if none); partial
    ``.tmp_`` saves are removed."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if name.startswith("step_") and ".tmp_" in name:
            shutil.rmtree(path, ignore_errors=True)
            continue
        if name.startswith("step_") and \
                os.path.exists(os.path.join(path, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _read(directory: str, step: int):
    """(manifest, {key: numpy array}) of a step, every process's shard
    file merged."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data: Dict[str, np.ndarray] = {}
    for p in range(manifest["process_count"]):
        fn = os.path.join(path, f"shard_{p}.npz")
        if os.path.exists(fn):
            with np.load(fn) as z:
                for k in z.files:
                    data[k] = z[k]
    return manifest, data


def _tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    if not arr.flags.c_contiguous:   # (np.ascontiguousarray makes 0-d 1-d)
        arr = np.ascontiguousarray(arr)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _strip(tree):
    """`tree` without its derived leaves."""
    if isinstance(tree, dict):
        return {k: _strip(v) for k, v in tree.items()
                if k not in DERIVED_KEYS}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_strip(v) for v in tree)
    return tree


def restore_checkpoint(directory: str, step: int, like: Any,
                       shardings: Optional[Any] = None) -> Any:
    """Restore step `step` into the structure of `like`, each leaf on its
    `like` leaf's device and in its dtype.  With `shardings` (a
    ``NamedSharding`` tree matching `like`, ``distributed.sharding.
    specs_to_shardings``) `like` holds shards: each full leaf read is cut
    to this rank's shard, onto any mesh (the elastic path)."""
    _, data = _read(directory, step)
    flat_sh = _flatten(shardings) if shardings is not None else {}
    leaves = {}
    for key, leaf in _flatten(like).items():
        arr = data[key]
        sh = flat_sh.get(key)
        t = _tensor(arr, leaf.dtype, leaf.device)
        if sh is not None:
            t = sh.local(t)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{arr.shape} ({tuple(t.shape)} here), the tree "
                             f"wants {tuple(leaf.shape)}")
        leaves[key] = t
    return _unflatten_like(like, leaves)


# ----------------------------------------------------------- quantized ----
def save_quantized(directory: str, step: int, params, cfg, rt=None,
                   plan=None, min_size: int = 1 << 12) -> str:
    """Pack the float masters `params` under the active plan (every site
    that serves from int4 nibbles becomes uint8 nibbles and bf16 scales)
    and save them with the plan and each packed site's backend in the
    manifest.  Pass `plan` (a QuantPlan) or `rt` (a Runtime selecting
    one).  Returns the checkpoint's path."""
    from ..core.quant_plan import (CKPT_PACKED, active_plan, plan_pack_tree,
                                   plan_to_dict)

    if plan is None:
        if rt is None:
            raise ValueError("save_quantized needs a plan or a Runtime")
        plan = active_plan(cfg, rt)
    site_backends: Dict[str, str] = {}
    packed = plan_pack_tree(params, cfg, plan, min_size=min_size,
                            backends=CKPT_PACKED,
                            scale_dtype=torch.bfloat16,
                            site_log=site_backends)
    if isinstance(packed["layers"], list):
        P = len(cfg.pattern)
        packed = {**packed, "layers": {
            f"r{r}": {f"u{j}": packed["layers"][r * P + j]
                      for j in range(P)}
            for r in range(cfg.n_repeats)}}
    return save_checkpoint(
        directory, step, packed,
        extra_meta={"format": QUANTIZED_FORMAT, "arch": cfg.name,
                    "plan": plan_to_dict(plan),
                    "site_backends": site_backends})


def check_plan(manifest: Dict, cfg, rt) -> None:
    """Raise unless the serving plan of (`cfg`, `rt`) rebuilds what the
    checkpoint was packed for: every packed site's backend first, then the
    whole plan's rules."""
    from ..core.quant_plan import active_plan, plan_from_dict

    stored = plan_from_dict(manifest["plan"])
    live = active_plan(cfg, rt)
    for site, saved_be in manifest.get("site_backends", {}).items():
        live_be = live.resolve(site).backend
        if live_be != saved_be:
            raise ValueError(
                f"site {site!r} does not match the plan this checkpoint was "
                f"saved with: packed for backend {saved_be!r} but the "
                f"runtime plan {live.name!r} resolves it to {live_be!r}; "
                f"restoring would serve the wrong kernel math — set "
                f"Runtime.quant_plan to the stored plan ({stored.name!r})")
    if live.rules != stored.rules:
        raise ValueError(
            f"runtime plan {live.name!r} does not match the plan this "
            f"checkpoint was saved with ({stored.name!r}); set "
            f"Runtime.quant_plan to the stored plan")


def restore_quantized(directory: str, step: Optional[int] = None, *,
                      cfg=None, rt=None, device="cuda"):
    """Restore a quantized checkpoint into a serving-ready packed tree on
    `device` (the card unless the caller asks for the CPU): no float
    master, no template, no packing at load.  The tree is built from the
    manifest's keys (uint8 nibbles stay uint8; bf16 leaves come back bit
    for bit).  With `cfg` and `rt` the serving plan is checked against the
    stored one (`check_plan`).  On CUDA every packed weight gets its
    planar K-major twin (``core.qlinear.prepack_tree``), which the kernels
    read.  Returns (params, manifest); the stored plan is
    ``quant_plan.plan_from_dict(manifest["plan"])``."""
    from ..core.qlinear import prepack_tree
    from ..serving.engine import resolve_device

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    manifest, data = _read(directory, step)
    if manifest.get("format") != QUANTIZED_FORMAT:
        raise ValueError(
            f"{os.path.join(directory, f'step_{step:08d}')} is not a "
            f"quantized checkpoint (format={manifest.get('format')!r}); use "
            "restore_checkpoint")
    if cfg is not None and rt is not None:
        check_plan(manifest, cfg, rt)
    dev = resolve_device(device)
    tree: Dict[str, Any] = {}
    for key in manifest["keys"]:
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _tensor(data[key],
                                  torch_dtype(manifest["dtypes"][key]), dev)
    layers = tree.get("layers")
    if isinstance(layers, dict) and "r0" in layers:
        # per-layer blocks: the port's list, block r * P + j at that index
        P = len(layers["r0"])
        tree["layers"] = [layers[f"r{r}"][f"u{j}"]
                          for r in range(len(layers)) for j in range(P)]
    if dev.type == "cuda":
        tree = prepack_tree(tree)
    return tree, manifest


class CheckpointManager:
    """Save every `save_every` steps, keep the last `keep`, resume from the
    latest; preemption-safe through `save_checkpoint`'s atomic rename."""

    def __init__(self, directory: str, save_every: int = 100, keep: int = 3):
        self.directory = directory
        self.save_every = save_every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, tree: Any, force: bool = False,
                   extra_meta: Optional[Dict] = None,
                   shardings: Optional[Any] = None) -> bool:
        """Save at every `save_every` steps (or when `force`d); with
        `shardings` every rank calls it and rank 0 writes."""
        if force or (step > 0 and step % self.save_every == 0):
            save_checkpoint(self.directory, step, tree, extra_meta,
                            shardings)
            if _rank() == 0:
                self._gc()
            _barrier()
            return True
        return False

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and ".tmp_" not in n)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore(self, like: Any, shardings=None, step: Optional[int] = None):
        """(the restored tree, its step): step `step`, or the latest;
        `shardings` as in `restore_checkpoint`."""
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return restore_checkpoint(self.directory, step, like, shardings), step
