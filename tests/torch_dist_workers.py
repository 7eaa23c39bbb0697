"""Rank bodies and helpers for the port's multi-process CPU tests
(``tests/test_torch_dist_*.py``).

`spawn` starts gloo ranks with ``torch.multiprocessing`` on a ``file://``
store under the test's temporary directory (no TCP port: several xdist
workers run at once).  Each body imports only torch, numpy and the port
(never JAX: the JAX references are computed once per test file in a
subprocess with fake host devices, `run_jax`), reads its inputs from
files and writes its results for the test process to compare.
"""

from __future__ import annotations

import datetime
import faulthandler
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ processes --
def spawn(fn, world: int, tmp, *args, backend: str = "gloo") -> None:
    """Run ``fn(rank, *args)`` in `world` ranks (gloo on the CPU; "nccl":
    rank r on card r) and wait for all.  Each rank's standard error goes
    to ``ranks_<fn>_<world>/rank<r>.stderr`` under `tmp` (with
    ``faulthandler`` on, so a crash leaves its Python stack there); when a
    rank fails, every rank's exit code is written beside them
    (``exitcodes.json``) and the error raised carries each rank's exit
    code and the end of its standard error."""
    import torch.multiprocessing as mp

    store = os.path.join(str(tmp), f"pg_{fn.__name__}_{world}")
    logs = os.path.join(str(tmp), f"ranks_{fn.__name__}_{world}")
    os.makedirs(logs, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(fn, world, store, args, backend,
                                           logs),
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join():
            pass
    except Exception as e:
        raise AssertionError(_rank_report(ctx.processes, logs, e)) from e


def _rank_report(processes, logs: str, err: Exception,
                 tail: int = 4000) -> str:
    codes = [p.exitcode for p in processes]
    with open(os.path.join(logs, "exitcodes.json"), "w") as f:
        json.dump({"exitcodes": codes, "error": str(err)}, f, indent=1)
    parts = [f"{type(err).__name__}: {err}", f"rank exit codes {codes} "
             f"(negative: killed by that signal); logs in {logs}"]
    for rank in range(len(processes)):
        try:
            with open(os.path.join(logs, f"rank{rank}.stderr"),
                      errors="replace") as f:
                text = f.read()
        except OSError as e:
            text = f"<unreadable: {e}>"
        parts.append(f"--- rank {rank} (exit {codes[rank]}) stderr, last "
                     f"{tail} chars ---\n{text[-tail:]}")
    return "\n".join(parts)


def _entry(rank, fn, world, store, args, backend="gloo", logs=None):
    if logs is not None:
        fd = os.open(os.path.join(logs, f"rank{rank}.stderr"),
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        os.dup2(fd, 2)
        os.close(fd)
        faulthandler.enable()
    torch.set_num_threads(1)
    kw = {}
    if backend == "nccl":
        # what torch.distributed.run tells a rank: its card
        os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120), **kw)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()
    # A rank whose work is done leaves without the interpreter's and the C++
    # runtime's exit-time teardown: there a four-rank gloo run once aborted
    # ("terminate called without an active exception", SIGABRT, no Python
    # frame) after rank 0 had written its results, which failed the test.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_jax(script: str, args=(), n_devices: int = 4,
            timeout: int = 600) -> str:
    """Run a JAX script (with command-line `args`) on `n_devices` fake host
    devices; its stdout."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n_devices} "
                        + env.get("XLA_FLAGS", ""))
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                         env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=REPO)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return out.stdout


def start(fn, world: int, tmp, *args):
    """Start `fn(rank, *args)` in `world` gloo ranks without waiting: the
    processes, each to be joined (and its exit code read) by the caller."""
    import torch.multiprocessing as mp

    store = os.path.join(str(tmp), f"pg_{fn.__name__}_{world}")
    return mp.start_processes(_entry, args=(fn, world, store, args),
                              nprocs=world, join=False,
                              start_method="spawn").processes


# ---------------------------------------------------------------- trees --
def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} with '/'-joined keys (numpy or torch leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def to_numpy(tree) -> dict:
    """A torch tree's leaves as float32 (or integer) numpy arrays."""
    out = {}
    for k, v in flatten(tree).items():
        t = v.detach().cpu()
        out[k] = (t.to(torch.float32) if t.dtype == torch.bfloat16
                  else t).numpy()
    return out


def save_npz(path, tree) -> None:
    np.savez(path, **flatten(tree))


def load_npz(path) -> dict:
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


# ---------------------------------------------------------- rank bodies --
def _mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes, device="cpu")


def _rows(x: torch.Tensor):
    from repro_torch.distributed.sharding import dp_rank, dp_size

    n = x.shape[0] // dp_size()
    return x[dp_rank() * n:(dp_rank() + 1) * n]


def train_worker(rank, jobs, lr):
    """For each job ``(out, mesh shape, cfg overrides, params npz, tokens
    npz, Runtime overrides)``: lm_loss on each token batch of the npz (keys "0", "1", ...),
    the gathered gradients of the last and one train step on it, on the
    mesh, from the JAX parameters, with the attention strategies taken."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed.sharding import (mesh_context, place,
                                                  sync_grads, tree_full)
    from repro_torch.launch.steps import _like, make_train_step
    from repro_torch.models import attention
    from repro_torch.models.transformer import lm_loss
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map

    seen = set()
    pick = attention._attn_strategy
    attention._attn_strategy = lambda n, s: seen.add(pick(n, s)) or pick(n, s)
    for out, shape, cfg_kw, params_npz, tokens_npz, rt_kw in jobs:
        rt = Runtime(**rt_kw)
        seen.clear()
        cfg_kw = dict(cfg_kw)
        cfg = get_config(cfg_kw.pop("arch")).reduced(**cfg_kw)
        full = params_from_jax(load_npz(params_npz), "cpu")
        with np.load(tokens_npz) as z:
            toks_all = [torch.from_numpy(z[k])
                        for k in sorted(z.files, key=int)]
        res = {}
        mesh = _mesh(shape)
        with mesh_context(mesh):
            params, sh = place(full, mesh)
            for i, toks in enumerate(toks_all):
                live = tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
                loss, _ = lm_loss(live, _rows(toks), cfg, rt)
                res[f"loss{i}"] = float(loss.detach())
            grads = torch.autograd.grad(loss, tree_leaves(live))
            gtree = sync_grads(_like(live, iter(grads)), sh)
            res["grads"] = to_numpy(tree_full(gtree, sh))
            state = {"params": params, "opt": adamw_init(params),
                     "step": torch.zeros((), dtype=torch.int32)}
            step = make_train_step(cfg, rt, peak_lr=lr, warmup=1,
                                   shardings=sh)
            state, metrics = step(state, _rows(toks_all[-1]))
            res["metrics"] = {k: float(v) for k, v in metrics.items()}
            res["params_after"] = to_numpy(tree_full(state["params"], sh))
        res["strategies"] = sorted(seen)
        if rank == 0:
            torch.save(res, out)



W4A4_RT = dict(quant_backend="w4a4_packed", compute_dtype="float32",
               cache_dtype="float32")


def w4a4_steps(params, cfg, rt, tokens, n_decode: int = 3):
    """A prefill of `tokens` [B, S] and `n_decode` greedy decode steps on
    the contiguous cache: every step's logits [B, Vp]."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_caches

    B, S = tokens.shape
    caches = init_caches(cfg, rt, B, 16, device="cpu")
    logits, caches = make_prefill_step(cfg, rt)(params, tokens, caches)
    out = [logits]
    dec = make_decode_step(cfg, rt)
    for i in range(n_decode):
        tok = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
        pos = torch.full((B, 1), S + i, dtype=torch.int32)
        logits, caches = dec(params, tok[:, None], caches, pos)
        out.append(logits)
    return [t.clone() for t in out]


def row_gemm_input(K: int, seed: int = 5) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((6, K), generator=g) * 3


def w4a4_worker(rank, jobs):
    """For each job ``(out, arch, tp, params npz, tokens npy)`` on a (1, tp)
    mesh: the W4A4-packed prefill and decode steps' logits, and the
    row-parallel W4A4 GEMM of layer 0's ``wo`` and ``ffn/w_out`` on a
    seeded input."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.convert import params_to_mesh
    from repro_torch.core.qlinear import prepack_tree
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.distributed.tensor_parallel import row_dense

    rt = Runtime(**W4A4_RT)
    for out, arch, tp, params_npz, tokens_npy in jobs:
        cfg = get_config(arch).reduced(n_layers=2)
        mesh = _mesh((1, tp))
        with mesh_context(mesh):
            params, _ = params_to_mesh(load_npz(params_npz), mesh)
            params = prepack_tree(params)
            toks = torch.from_numpy(np.load(tokens_npy))
            res = {"logits": [t.numpy() for t in
                              w4a4_steps(params, cfg, rt, toks)]}
            layer = params["layers"]["u0"]
            for name, w, K in (("wo", layer["attn"]["wo"],
                                cfg.n_heads * cfg.hd),
                               ("w_out", layer["ffn"]["w_out"], cfg.d_ff)):
                w0 = {k: v[0] for k, v in w.items()}
                res[name] = row_dense(w0, row_gemm_input(K),
                                      rt.quant_cfg(cfg, "x"), k_in=K).numpy()
        if rank == 0:
            torch.save(res, out)


PAGED_RT = dict(attn_impl="flash", paged_attn="fused", quant_backend="float",
                compute_dtype="float32", cache_dtype="float32")


def paged_kernel_steps(cfg, mesh=None, n_decode: int = 3, device="cpu",
                       rt_kw=PAGED_RT, feed=None):
    """Seeded parameters (placed on `mesh` when given); a prefill of seeded
    tokens [2, 8] through flash prefill and `n_decode` greedy decode steps
    through the fused paged decode, on paged caches: (every step's logits,
    the kernels' calls {name: count}).  `feed` [n_decode, 2] gives the
    decode steps' tokens instead of the greedy ones."""
    import types

    from repro_torch.configs import Runtime
    from repro_torch.distributed.sharding import mesh_context, place
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.kv_pages import (init_paged_caches,
                                              with_block_tables)

    rt = Runtime(**rt_kw)
    calls = {"flash_prefill": 0, "paged_decode_attention": 0}
    real = {k: getattr(ops, k) for k in calls}

    def spy(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    full = init_model(torch.Generator(device).manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)).to(device)
    B, S = toks.shape
    with mesh_context(mesh):
        params = place(full, mesh)[0] if mesh is not None else full
        del full
        caches = init_paged_caches(
            cfg, rt, types.SimpleNamespace(num_pages=8, page_size=4), device)
        caches = with_block_tables(caches, torch.arange(
            8, dtype=torch.int32, device=device).reshape(B, 4))
        for k in calls:
            setattr(ops, k, spy(k))
        try:
            logits, caches = make_prefill_step(cfg, rt)(params, toks, caches)
            out = [logits.clone()]
            dec = make_decode_step(cfg, rt)
            for i in range(n_decode):
                tok = (torch.argmax(logits[:, :cfg.vocab], -1) if feed is None
                       else torch.as_tensor(feed[i], device=device))
                pos = torch.full((B, 1), S + i, dtype=torch.int32,
                                 device=device)
                logits, caches = dec(params, tok.to(torch.int32)[:, None],
                                     caches, pos)
                out.append(logits.clone())
        finally:
            for k, fn in real.items():
                setattr(ops, k, fn)
    return [t.float().cpu().numpy() for t in out], calls


PAGED_CUDA_RT = dict(PAGED_RT, compute_dtype="bfloat16",
                     cache_dtype="bfloat16")


def paged_cuda_worker(rank, out, arch, n_layers):
    """Full-width `arch` cut to `n_layers`, on card `rank`: the unsharded
    `paged_kernel_steps` and the same on a (1, world) NCCL mesh, its
    decode fed the unsharded run's greedy tokens; with the mesh run's
    kernel launches (counts zeroed just before it), written by rank 0."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    dev = torch.device("cuda", rank)
    want, _ = paged_kernel_steps(cfg, None, device=dev, rt_kw=PAGED_CUDA_RT)
    feed = [np.argmax(w[:, :cfg.vocab], -1) for w in want[:-1]]
    mesh = make_mesh_cuda((1, dist.get_world_size()))
    ops.reset_launch_counts()
    got, calls = paged_kernel_steps(cfg, mesh, device=dev,
                                    rt_kw=PAGED_CUDA_RT, feed=feed)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if rank == 0:
        torch.save({"want": want, "got": got, "calls": calls,
                    "launches": launches, "feed": feed}, out)


def make_mesh_cuda(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes, device="cuda")


def paged_tp_worker(rank, out, cases):
    """For each ``(name, cfg overrides)``: `paged_kernel_steps` on a (1, world)
    mesh, written by rank 0 under ``out``."""
    from repro_torch.configs import get_config

    mesh = _mesh((1, dist.get_world_size()))
    res = {}
    for name, kw in cases:
        kw = dict(kw)
        res[name] = paged_kernel_steps(
            get_config(kw.pop("arch")).reduced(**kw), mesh)
    if rank == 0:
        torch.save(res, out)


MOE_RT = dict(quant_backend="float", compute_dtype="float32")


def moe_cfg(arch: str):
    from repro_torch.configs import get_config

    return get_config(arch).reduced(n_experts=8, d_model=64, d_ff_expert=64,
                                    capacity_factor=64.0)


def _gather_rows(x: torch.Tensor) -> torch.Tensor:
    """This data rank's rows made whole (ranks in data order)."""
    from repro_torch.distributed.sharding import current_mesh

    group = current_mesh().group("data")
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)


def moe_pipe_worker(rank, d):
    """On a (2, 2) mesh: apply_moe's output and aux for arctic-480b and the
    gradients of sum(y**2) for llama4 (reduced, 8 experts); then, on a
    4-stage mesh, pipeline_apply of tanh(x @ w) stages."""
    from repro_torch.configs import Runtime
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import (mesh_context, place,
                                                  sync_grads, tree_full)
    from repro_torch.launch.steps import _like
    from repro_torch.models.moe import apply_moe
    from repro_torch.optim.adamw import tree_leaves, tree_map

    rt = Runtime(**MOE_RT)
    res = {}
    mesh = _mesh((2, 2))
    with mesh_context(mesh):
        for arch in ("arctic-480b", "llama4-maverick-400b-a17b"):
            cfg = moe_cfg(arch)
            full = tree_map(torch.from_numpy, load_npz(f"{d}/{arch}_moe.npz"))
            x = full.pop("x")
            params, sh = place(full, mesh)
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            y, aux = apply_moe(live, _rows(x), cfg, rt)
            grads = torch.autograd.grad(torch.sum(y ** 2), tree_leaves(live))
            grads = sync_grads(_like(live, iter(grads)), sh)
            aux_all = _gather_rows(aux.detach()[None])
            res[arch] = {"y": _gather_rows(y.detach()).numpy(),
                         "aux": float(aux_all.mean()),
                         "grads": to_numpy(tree_full(grads, sh))}
    with np.load(f"{d}/pipe.npz") as z:
        ws, x = torch.from_numpy(z["ws"]), torch.from_numpy(z["x"])
    stages = _mesh((4,), ("stage",))
    res["pipe"] = pipeline_apply(lambda w, xb: torch.tanh(xb @ w), ws, x,
                                 mesh=stages, n_micro=8).numpy()
    if rank == 0:
        torch.save(res, f"{d}/moe_pipe.pt")


def ckpt_worker(rank, d, cfg_kw):
    """Save the JAX parameters from a (2, 2) mesh; restore that checkpoint
    onto a (1, 4) mesh, and the JAX package's checkpoint (saved from its
    own sharded parameters) onto a (2, 2) mesh; each restored tree
    gathered whole and written by rank 0."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import params_to_mesh
    from repro_torch.distributed.sharding import mesh_context, tree_full

    full = load_npz(f"{d}/params.npz")
    mesh_a = _mesh((2, 2))
    with mesh_context(mesh_a):
        local, sh = params_to_mesh(full, mesh_a)
        CheckpointManager(f"{d}/port_ckpt", save_every=1).maybe_save(
            1, local, force=True, shardings=sh)
        like, _ = params_to_mesh(full, mesh_a)
        jax_on_a, step = CheckpointManager(f"{d}/jax_ckpt").restore(
            like, shardings=sh)
        jax_on_a = to_numpy(tree_full(jax_on_a, sh))
    mesh_b = _mesh((1, 4))
    with mesh_context(mesh_b):
        like, sh_b = params_to_mesh(full, mesh_b)
        on_b, _ = CheckpointManager(f"{d}/port_ckpt").restore(
            like, shardings=sh_b)
        on_b = to_numpy(tree_full(on_b, sh_b))
    if rank == 0:
        save_npz(f"{d}/port_on_1x4.npz", on_b)
        save_npz(f"{d}/jax_on_2x2.npz", jax_on_a)


CONFIG_RT = dict(loss_chunk=0, compute_dtype="float32", quant_backend="float")


def config_loss(arch: str, mesh=None, part=None):
    """The reduced `arch`'s lm_loss and gradients (seeded port parameters,
    seeded tokens [4, 17]) under `mesh` (None: one process); the
    gradients gathered whole.  `part` (i, n): one process on the i-th of n
    equal row slices of the tokens."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.distributed.sharding import (mesh_context, place,
                                                  sync_grads, tree_full)
    from repro_torch.launch.steps import _like
    from repro_torch.models.transformer import init_model, lm_loss
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = get_config(arch).reduced()
    rt = Runtime(**CONFIG_RT)
    full = init_model(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 17)).astype(np.int32))
    if part is not None:
        n = toks.shape[0] // part[1]
        toks = toks[part[0] * n:(part[0] + 1) * n]
    with mesh_context(mesh):
        params, sh = place(full, mesh) if mesh is not None else (full, None)
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = lm_loss(live, _rows(toks) if mesh is not None else toks,
                          cfg, rt)
        grads = _like(live, iter(torch.autograd.grad(loss,
                                                     tree_leaves(live))))
        if mesh is not None:
            grads = tree_full(sync_grads(grads, sh), sh)
    return float(loss.detach()), to_numpy(grads)


def configs_worker(rank, out, archs, shapes):
    res = {}
    for shape in shapes:
        mesh = _mesh(shape)
        for arch in archs:
            res[(arch, tuple(shape))] = config_loss(arch, mesh)
    if rank == 0:
        torch.save(res, out)


def dying_rank_worker(rank):
    """Rank 1 writes a line to its standard error and exits with code 7
    before the barrier that rank 0 waits in."""
    if rank == 1:
        print("rank 1 exits with 7", file=sys.stderr, flush=True)
        os._exit(7)
    dist.barrier()


def failing_train_worker(rank, out):
    """`train` on a (1, 2) mesh whose step raises once, on rank 1 alone,
    before its first collective; a rank whose run ends writes
    ``out.<rank>``."""
    import repro_torch.launch.train as T

    make = T.make_train_step

    def make_failing(*a, **kw):
        step, calls = make(*a, **kw), []

        def failing(state, tokens):
            calls.append(1)
            if rank == 1 and len(calls) == 1:
                raise RuntimeError("injected step failure")
            return step(state, tokens)
        return failing

    T.make_train_step = make_failing
    T.train("qwen2-0.5b", steps=2, batch=2, seq=8, ckpt_dir=None,
            mesh_spec="1,2", device="cpu")
    with open(f"{out}.{rank}", "w") as f:
        f.write("finished")


# ------------------------------------------- pipeline gradients (GPipe) --
def pipe_stage(case: str):
    """The stage function of a pipeline-gradient case: ``tanh(x @ w)``, or
    a reduced qwen2-0.5b "A" block in float32 (one block a stage; its own
    positions 0..S-1)."""
    if case == "tanh":
        return lambda w, xb: torch.tanh(xb @ w)
    from repro_torch.configs import Runtime, get_config
    from repro_torch.models.transformer import apply_block

    cfg = get_config("qwen2-0.5b").reduced(n_layers=4)
    rt = Runtime(quant_backend="float", compute_dtype="float32",
                 attn_impl="full", remat="none")

    def block(p, xb):
        B, S = xb.shape[:2]
        pos = torch.arange(S, dtype=torch.int32).repeat(B, 1)
        return apply_block("A", p, xb, cfg, rt, pos)[0]

    return block


def pipe_loss(y: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.sum(y * r)


def pipe_grad_worker(rank, d, cases):
    """On a 4-stage mesh, for each case: pipeline_apply's outputs and the
    gradients of sum(y * r) with respect to the stacked parameters and x
    (every rank's; rank r's saved as ``<case>_rank<r>.pt``)."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import COLLECTIVES
    from repro_torch.optim.adamw import tree_leaves, tree_map

    stages = _mesh((4,), ("stage",))
    for case in cases:
        fn = pipe_stage(case)
        full = tree_map(torch.from_numpy, load_npz(f"{d}/{case}_in.npz"))
        x, r = full.pop("x"), full.pop("r")
        ws = full["ws"] if case == "tanh" else full
        live = tree_map(lambda p: p.detach().requires_grad_(True), ws) \
            if isinstance(ws, dict) else ws.detach().requires_grad_(True)
        xl = x.detach().requires_grad_(True)
        COLLECTIVES.log = []
        y = pipeline_apply(fn, live, xl, mesh=stages, n_micro=8)
        leaves = tree_leaves(live) if isinstance(live, dict) else [live]
        grads = torch.autograd.grad(pipe_loss(y, r), [xl, *leaves])
        log, COLLECTIVES.log = COLLECTIVES.log, None
        names = (sorted(flatten(live)) if isinstance(live, dict)
                 else ["ws"])
        torch.save({"y": y.detach().numpy(),
                    "gx": grads[0].numpy(),
                    "g": {n: g.numpy() for n, g in zip(names, grads[1:])},
                    "log": [k for k, _, _ in log]},
                   f"{d}/{case}_rank{rank}.pt")


# ------------------------------------------------- row-parallel GEMMs --
def rows_worker(rank, d, tp, cases):
    """On a (1, tp) mesh, for each case ``(name, backend, group_size,
    a_bits, packed)``: ``row_dense`` of this rank's K slices of the
    seeded input and weight (``<name>.npz``), and the collectives it
    called (the ledger's kinds and bytes)."""
    from repro_torch.core.qlinear import QuantConfig, pack_weight_nd
    from repro_torch.core.qlinear import prepack_tree
    from repro_torch.distributed.sharding import (COLLECTIVES,
                                                  mesh_context, place)
    from repro_torch.distributed.tensor_parallel import row_dense

    mesh = _mesh((1, tp))
    res = {}
    with mesh_context(mesh):
        for name, backend, G, a_bits, packed in cases:
            with np.load(f"{d}/{name}.npz") as z:
                w, x = torch.from_numpy(z["w"]), torch.from_numpy(z["x"])
            qc = QuantConfig(backend=backend, group_size=G, a_bits=a_bits)
            K = w.shape[0]
            tree = {"wo": pack_weight_nd(w, qc) if packed else w}
            local, _ = place(tree, mesh)
            wl = prepack_tree(local)["wo"] if packed else local["wo"]
            k = K // tp
            xl = x[:, rank * k:(rank + 1) * k]
            COLLECTIVES.log = []
            with torch.no_grad():
                y = row_dense(wl, xl, qc, k_in=K, x_sharded=True)
            log, COLLECTIVES.log = COLLECTIVES.log, None
            res[name] = {"y": y.numpy(), "log": log}
    if rank == 0:
        torch.save(res, f"{d}/rows_tp{tp}.pt")
