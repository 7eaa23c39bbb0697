"""Mesh builders (PyTorch port of ``repro/launch/mesh.py``): functions, not
module constants, so importing this module starts no process group.

A mesh lays named axes over the ranks of the default process group
(``torch.distributed``) through ``init_device_mesh``.  The group's backend
follows the device: NCCL for ``cuda`` (one card a rank, the card of the
rank's ``LOCAL_RANK``), gloo for ``cpu``.  `init_distributed` joins the
group a launcher describes (``torch.distributed.run`` sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``) or, with none,
starts a group of one process on a ``file://`` store.  A ``cuda`` request
without NCCL or without a card for every local rank raises: nothing falls
back to gloo or to the CPU.

The dry-run (``launch.dryrun``) lays its meshes over a group on PyTorch's
``fake`` backend (`init_fake`): N ranks in one process, whose collectives
move nothing.  Its meshes are asked for with ``device="fake"``; a ``cuda``
or ``cpu`` mesh on a fake group raises, as a ``fake`` mesh on a real group
does.

The port's mesh axes are the named ones of ``distributed.sharding.Mesh``,
over which the model code's collectives run (the JAX package's
``jax.make_mesh`` builds Explicit axes under jax 0.9, which its own
``with_sharding_constraint`` refuses).
"""

from __future__ import annotations

import os
import tempfile
from typing import Sequence

import torch
import torch.distributed as dist

from ..distributed.sharding import Mesh


def init_fake(world: int) -> None:
    """Make the default process group one of `world` ranks on the ``fake``
    backend, this process rank 0 (a fake group of another size is
    replaced; a real group raises).  The only user of PyTorch's private
    ``torch.testing._internal.distributed.fake_pg``."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry-run's fake process group needs torch.testing._internal."
            f"distributed.fake_pg, which PyTorch {torch.__version__} "
            "lacks") from e
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group is running; the "
                "dry-run's fake group would replace it")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def backend_for(device) -> str:
    """NCCL for ``cuda``, gloo for ``cpu``, the fake backend for
    ``"fake"``; raises where the device's backend is missing."""
    if device == "fake":
        return "fake"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a GPU; pass device='cpu' "
                               "for gloo on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda mesh needs NCCL, which this PyTorch "
                               "build lacks")
        return "nccl"
    if dev.type == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("a cpu mesh needs gloo, which this PyTorch "
                               "build lacks")
        return "gloo"
    raise ValueError(f"no mesh backend for device {device!r}")


def init_distributed(device="cuda") -> torch.device:
    """Join (or start) the default process group on `device`'s backend and
    return this rank's device.  Under a launcher the group is the
    launcher's (``env://``); otherwise a group of one process on a
    ``file://`` store in a fresh temporary directory.  On ``cuda`` each
    rank takes the card of its ``LOCAL_RANK``, and a node with fewer cards
    than local ranks raises."""
    backend = backend_for(device)
    if backend == "fake":
        if not dist.is_initialized() or dist.get_backend() != "fake":
            raise RuntimeError("a fake mesh needs the fake process group "
                               "(launch.mesh.init_fake)")
        return torch.device("cpu")
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        if torch.cuda.device_count() < n_local:
            raise RuntimeError(
                f"{n_local} ranks on this node but {torch.cuda.device_count()}"
                " CUDA devices: NCCL takes one card a rank")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()}, but a "
                f"{dev.type} mesh needs {backend}")
        return dev
    # NCCL is told its card (a barrier would otherwise guess it from the
    # rank)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"),
                             "store")
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=0, world_size=1, **kw)
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device="cuda") -> Mesh:
    """A mesh of `shape` over `axes` on the default process group, which
    must hold exactly prod(shape) ranks (`init_distributed` starts one of
    a single process where none is running).  ``device="fake"`` lays it
    over the fake group of `init_fake`, its tensors on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} against axes {axes}")
    n = 1
    for s in shape:
        n *= s
    if n != 1 and not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        raise ValueError(f"a {shape} mesh needs {n} ranks; no process group "
                         "or launcher is running (start one rank a process, "
                         "e.g. with torch.distributed.run)")
    dev = init_distributed(device)
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    return Mesh(dict(zip(axes, shape)), dm, dev)


def single_device_mesh(device="cuda") -> Mesh:
    return make_mesh((1, 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The assignment's production mesh: 16 x 16 (256 ranks), or 2 pods of
    them (512) with a leading ``pod`` axis.  Raises unless the process
    group has that many ranks (the dry-run's fake group, ``device="fake"``,
    has them on one host)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != want:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"the production mesh needs {want} ranks; the "
                           f"process group has {have}")
    return make_mesh(shape, axes, device)


def mesh_from_spec(spec: str, device="cuda") -> Mesh:
    """The trainer's ``--mesh``: "d,m" over (data, model), "p,d,m" over
    (pod, data, model)."""
    dims = tuple(int(x) for x in spec.split(","))
    if len(dims) not in (2, 3):
        raise ValueError(f"--mesh {spec!r}: want 'd,m' or 'p,d,m'")
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return make_mesh(dims, axes, device)
