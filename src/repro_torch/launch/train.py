"""End-to-end trainer with fault tolerance (PyTorch port of
``repro/launch/train.py``).

Runs `launch.steps.make_train_step` over the deterministic synthetic
pipeline (``data.SyntheticLMDataset``) with atomic checkpoints and resume
from the latest (``checkpoint.CheckpointManager``, the JAX package's
on-disk format), a per-step watchdog (``distributed.fault_tolerance``) and
bounded retries (on one process only: under a mesh a failed step raises
on its rank, and its peers' collectives fail with it).  Runs on ``cuda``
unless ``device="cpu"`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --reduced --device cpu --steps 20 --batch 4 --seq 32 \
        --ckpt /tmp/run1 --quant fake_quant

``--mesh d,m`` (or ``p,d,m``, adding the ``pod`` axis) trains data x
tensor parallel over the ranks of a launcher, one process a rank (NCCL on
``cuda``, one card each; gloo on ``cpu``):

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen2-0.5b --mesh 2,2 \
        --device cpu --steps 3 --batch 4 --seq 16 --ckpt /tmp/run2

Every rank builds the same seeded parameters and keeps its shards as the
rules place them (``distributed.sharding``), the AdamW moments mirroring
them; each data rank takes its rows of the same global batch.  Rank 0
alone writes checkpoints (gathered whole, so either package and any mesh
restores them) and prints the last line of standard output,
``{"first_loss", "last_loss", "steps"}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import Runtime, get_config
from ..data import SyntheticLMDataset, make_batch_iterator
from ..distributed.fault_tolerance import StepTimer, Watchdog, run_with_retries
from ..distributed.sharding import dp_rank, dp_size, mesh_context, place
from ..optim import adamw_init
from ..serving.engine import resolve_device
from .mesh import mesh_from_spec
from .steps import init_train_state, make_train_step, train_shardings

log = logging.getLogger("repro_torch.train")

#: the CLI's checkpoint directory unless --ckpt names one
DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128,
          reduced: bool = True, ckpt_dir: Optional[str] = DEFAULT_CKPT,
          save_every: int = 50, mesh_spec: str = "", peak_lr: float = 3e-4,
          quant_backend: Optional[str] = None, step_deadline_s: float = 600.0,
          log_every: int = 10, seed: int = 0, device="cuda",
          cfg=None, on_step: Optional[Callable] = None, remat: str = "dots"):
    """Train `arch` (its reduced config unless `reduced` is false, or
    `cfg` when given) for `steps` steps of `batch` sequences of `seq`
    tokens; returns (the final train state, every step's loss).

    With a `ckpt_dir` the state is saved every `save_every` steps and at
    the end (the last 3 kept), and a run finding a checkpoint there
    resumes from its latest step; ``ckpt_dir=None`` keeps no checkpoints.
    `on_step(step, metrics, seconds)` is called after every step with the
    step's metrics as floats and its wall time (the device synchronized).
    `mesh_spec` ("d,m" or "p,d,m") trains over a mesh of the process
    group's ranks (``launch.mesh.mesh_from_spec``); the state returned
    then holds this rank's shards.  `remat` is ``Runtime.remat`` (what a
    block keeps for the backward; never the numbers)."""
    mesh = mesh_from_spec(mesh_spec, device) if mesh_spec else None
    dev = mesh.device if mesh is not None else resolve_device(device)
    if cfg is None:
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
    rt = Runtime(attn_impl="chunked", attn_chunk_q=min(512, seq),
                 loss_chunk=0, quant_backend=quant_backend, remat=remat)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                            seed=seed)
    mgr = (CheckpointManager(ckpt_dir, save_every=save_every, keep=3)
           if ckpt_dir else None)
    with mesh_context(mesh):
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_train_state(gen, cfg)
        shardings = None
        if mesh is not None:
            params, psh = place(state["params"], mesh)
            state = {"params": params, "opt": adamw_init(params),
                     "step": state["step"]}
            shardings = train_shardings(psh, mesh)
            if batch % dp_size():
                raise ValueError(f"batch {batch} does not divide over "
                                 f"{dp_size()} data ranks")
        rows = batch // dp_size()
        start_step = 0
        if mgr is not None and mgr.latest() is not None:
            state, start_step = mgr.restore(state, shardings)
            log.info("resumed from step %d", start_step)

        step_fn = make_train_step(cfg, rt, peak_lr=peak_lr,
                                  total_steps=max(steps, 1),
                                  shardings=shardings)
        it = make_batch_iterator(ds, start_step=start_step)
        timer = StepTimer()
        history = []
        wd = Watchdog(deadline_s=step_deadline_s)
        lead = dp_rank() * rows
        try:
            for step in range(start_step, steps):
                tokens = torch.from_numpy(next(it)[lead:lead + rows]).to(dev)

                def one_step():
                    with wd:
                        return step_fn(state, tokens)

                timer.start()
                # a rank that retried alone would pair its collectives
                # with its peers' later ones: under a mesh a failed step
                # ends the run on every rank
                state, metrics = (one_step() if mesh is not None else
                                  run_with_retries(one_step, max_retries=2))
                vals = {k: float(v) for k, v in metrics.items()}
                dt = timer.stop()
                history.append(vals["loss"])
                if on_step is not None:
                    on_step(step, vals, dt)
                if step % log_every == 0 or step == steps - 1:
                    log.info("step %5d loss %.4f gnorm %.3f lr %.2e %.0f ms",
                             step, vals["loss"], vals["grad_norm"],
                             vals["lr"], dt * 1e3)
                if mgr is not None:
                    mgr.maybe_save(step + 1, state, shardings=shardings)
        finally:
            it.close()
        if mgr is not None:
            mgr.maybe_save(steps, state, force=True, shardings=shardings)
    return state, history


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    grp = ap.add_mutually_exclusive_group()
    grp.add_argument("--reduced", action="store_true", default=True)
    grp.add_argument("--full", dest="reduced", action="store_false",
                     help="the full (not reduced) config")
    ap.add_argument("--ckpt", default=DEFAULT_CKPT,
                    help="checkpoint directory (resumes from its latest)")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--quant", default=None,
                    help="override the quant backend (float|fake_quant|"
                         "int_sim)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="",
                    help="'d,m' (data, model) or 'p,d,m' (pod, data, model) "
                         "over the launcher's ranks")
    args = ap.parse_args(argv)
    try:
        _, history = train(
            args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
            reduced=args.reduced, ckpt_dir=args.ckpt,
            save_every=args.save_every, mesh_spec=args.mesh,
            peak_lr=args.lr, quant_backend=args.quant, seed=args.seed,
            device=args.device)
        # a run that found its last step on disk trained none (the JAX CLI
        # raises an IndexError there)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(json.dumps({"first_loss": history[0] if history else None,
                              "last_loss": history[-1] if history else None,
                              "steps": len(history)}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
