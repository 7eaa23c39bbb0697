"""Multi-pod dry-run (PyTorch port of ``repro/launch/dryrun.py``): prove the
distribution config is coherent without hardware.  For every (architecture
x input shape x mesh) cell this builds the real step function's inputs on
the production mesh (single-pod 16 x 16 = 256 ranks; multi-pod 2 x 16 x 16
= 512) and runs the step once on tensors that have shapes and no storage,
counting what it does; it writes one JSON report a cell.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out reports/dryrun]
  python -m repro_torch.launch.dryrun --arch ... --mesh 2,4      (tests)

How it runs.  The mesh lies over a process group on PyTorch's ``fake``
backend (``launch.mesh.init_fake``): the mesh's size in ranks, all in this
process, which is rank 0; its collectives move nothing.  The cell runs
under a ``FakeTensorMode`` on fake CPU tensors, so ``kernels.ops``
dispatches every kernel call to its plain version (a fake ``cuda`` tensor
would reach the CUDA wrappers, which read a data pointer it does not
have).  Nothing is launched, no device is touched and no value is
computed: this is a count, never a stand-in for a run, and `count_step`
refuses a real tensor.  There is no ``--devices`` (the group's size is
the mesh's product) and no ``scan_layers`` (the port loops over layers in
Python).

What stands in for each XLA artifact of the JAX dry-run:

  * ``memory_analysis`` -> the fake tensors' bytes.  Arguments: this
    rank's shards of the parameters (serving: packed as the engine packs
    them, with the kernels' planar K-major twins, reported apart as
    ``derived``) or of the train state, the inputs and the caches.
    Outputs: the step's result tensors.  Aliased: outputs that are
    argument storage (caches written in place).  Temporaries: the peak of
    the live storage the step allocates, tracked op by op (`_Counter`),
    less the outputs it ends holding.  ``total_hbm_bytes`` sums them as
    the JAX module does (arguments + outputs + temporaries - aliased).
    Temporaries are the plain versions', not the CUDA kernels'.
  * ``cost_analysis`` -> ``torch.utils.flop_counter.FlopCounterMode``'s
    FLOPs (matmuls, batched matmuls, convolutions, attention), and the
    bytes accessed by the ops the step launches on the card (`_Counter`):
    a kernel's call (``kernels.ops``, through ``ops.COUNT_CALL``) counts
    its operands and result once each at their stored size (packed
    weights, int4 caches), and none of its plain version's ops, whose
    dequantized temporaries the kernel never writes; every other op
    counts its tensor operands and results, as eager PyTorch runs it
    unfused.  The FLOPs of the W4A4 kernels' calls (the fused and unfused
    GEMMs, the table-lookup one) are timed at the int8 rate
    (``int8_fraction`` of ``roofline.roofline_terms``), the rest at the
    bf16 rate.
  * collective bytes parsed from the HLO -> the collective ledger
    (``distributed.sharding.COLLECTIVES``): the operand bytes of every
    collective the port's code calls, by kind, cross-pod where the group
    holds the ``pod`` axis.
  * the cost probes at 2 and 4 repeats (a train cell's where ZeRO splits
    the layer dimension at full depth: `train_probes`) -> a check.  The
    JAX dry-run extrapolates from them because XLA counts a scanned loop's
    body once;
    the port counts every layer at full depth
    (``cost_scanned_body_once`` holds that full-depth count), so the
    probes' line taken to full depth must equal it, and a cell where it
    does not fails (an op counted per run rather than per layer).  The
    JAX ``probe_runtime`` has no counterpart: its probes unroll the scan
    and drop remat and loss chunking so that XLA counts every op, while
    the port's probes run the production runtime, as the full-depth count
    does.

The train cell places the state as the JAX dry-run does
(``state_specs(cfg, mesh)``, ZeRO): the AdamW moments are split over
``data`` as well, and the train step reduce-scatters their gradients and
all-gathers the updated parameters (``steps.make_train_step``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import REGISTRY, SHAPES, Runtime, get_config, runnable
from ..distributed.sharding import (COLLECTIVES, mesh_context, place,
                                    tree_local)
from . import roofline as rl
from .steps import (TensorSpec, init_train_state, input_specs,
                    make_decode_step, make_prefill_step, make_train_step,
                    state_specs)

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


def production_runtime(shape_kind: str, serve_packed: bool = True,
                       **overrides) -> Runtime:
    """Production execution knobs per step kind."""
    base = dict(attn_impl="chunked", attn_chunk_q=512, loss_chunk=4096,
                remat="dots")
    if shape_kind == "train":
        base.update(quant_backend="fake_quant")
    else:
        # serving: pre-packed int4 weights + int4 KV cache (the paper's
        # 4-bit format applied to both weight and cache traffic)
        base.update(quant_backend="w4a4_packed" if serve_packed else "float",
                    cache_dtype="int4" if serve_packed else "bfloat16",
                    remat="none")
    base.update(overrides)
    return Runtime(**base)


# ------------------------------------------------------------ the cell --
@dataclasses.dataclass
class Cell:
    """One cell's step and its fake arguments on this rank."""
    cfg: object
    fn: object
    args: tuple
    #: argument bytes by part: params (or state), derived (the packed
    #: weights' K-major twins), inputs, caches
    parts: Dict[str, int]


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _derived_bytes(tree) -> int:
    """Bytes of the planar K-major twins in a packed parameter tree."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) if k == "packed_km" else _derived_bytes(v)
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_derived_bytes(v) for v in tree)
    return 0


def materialize(specs):
    """Tensors of a `TensorSpec` tree at their local shapes (zeros: under
    the dry-run's fake mode, shapes without storage)."""
    if isinstance(specs, TensorSpec):
        return torch.zeros(specs.local_shape, dtype=specs.dtype)
    if isinstance(specs, dict):
        return {k: materialize(v) for k, v in specs.items()}
    return type(specs)(materialize(v) for v in specs)


def lower_cell(arch: str, shape_name: str, mesh, *,
               repeats_override: Optional[int] = None,
               rt_overrides: Optional[Dict] = None,
               serve_packed: bool = True) -> Cell:
    """Build one assigned cell's step and this rank's fake arguments on
    `mesh` (call under a ``FakeTensorMode``)."""
    cfg = get_config(arch)
    if repeats_override is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=repeats_override * len(cfg.pattern)
            + len(cfg.tail))
    shape = SHAPES[shape_name]
    rt = production_runtime(shape.kind, serve_packed=serve_packed,
                            **(rt_overrides or {}))
    return build_cell(cfg, shape, rt, mesh)


def build_cell(cfg, shape, rt: Runtime, mesh) -> Cell:
    """The step of `shape`'s kind (``configs.Shape``: its batch and
    sequence) under `rt`, with this rank's arguments on `mesh`: the train
    state placed as the trainer places it and the batch, or the serving
    parameters packed and placed as the engine builds them, the prompt or
    decode token and positions, and the contiguous caches (call under a
    ``FakeTensorMode``)."""
    from ..core.quant_plan import pack_for_serving
    from ..models.transformer import init_model

    with mesh_context(mesh):
        specs = input_specs(cfg, shape, mesh, rt)
        if shape.kind == "train":
            _, shard = state_specs(cfg, mesh)
            state = tree_local(
                init_train_state(torch.Generator().manual_seed(0), cfg),
                shard)
            batch = materialize(specs["batch"])
            fn = make_train_step(cfg, rt, shardings=shard)
            return Cell(cfg, fn, (state, batch),
                        {"params": _nbytes(state), "derived": 0,
                         "inputs": _nbytes(batch), "caches": 0})
        # the tree ``serving.engine.build_params`` builds a layer at a time
        # (equal to it bit for bit); on fake tensors the whole-tree pack
        # dispatches a sixth of the ops (an expert stack at once)
        params, _ = place(pack_for_serving(init_model(
            torch.Generator().manual_seed(0), cfg), cfg, rt), mesh)
        caches = materialize(specs["caches"])
        derived = _derived_bytes(params)
        parts = {"params": _nbytes(params) - derived, "derived": derived,
                 "caches": _nbytes(caches)}
        if shape.kind == "prefill":
            tokens = materialize(specs["tokens"])
            parts["inputs"] = _nbytes(tokens)
            return Cell(cfg, make_prefill_step(cfg, rt),
                        (params, tokens, caches), parts)
        token = materialize(specs["token"])
        positions = materialize(specs["positions"])
        parts["inputs"] = _nbytes(token) + _nbytes(positions)
        return Cell(cfg, make_decode_step(cfg, rt),
                    (params, token, caches, positions), parts)


# ------------------------------------------------------------ counting --
def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


#: the kernels whose FLOPs run at the int8 rate (the W4A4 GEMMs)
INT8_KERNELS = ("int4_matmul_fused", "int4_matmul", "lut4_matmul")


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    """Bytes accessed and the peak of live storage allocated by the step's
    ops.  Bytes: a kernel's call (`kernel_call`, ``ops.COUNT_CALL``) its
    tensor operands and results, and nothing of the plain version that
    stands in for it; any other op that returns a tensor and not a view
    of one, its tensor operands and results.  `int8_flops`: the FLOPs
    `flop_mode` counted inside the calls of INT8_KERNELS.  Peak: each new
    storage counts from the op that makes it until the last tensor on it
    is freed, the plain versions' temporaries included.  Storage in
    `keep` (the arguments') is not counted."""

    def __init__(self, keep, flop_mode):
        super().__init__()
        self.keep = set(keep)
        self.flop_mode = flop_mode
        self.bytes_accessed = 0
        self.int8_flops = 0
        self.depth = 0                   # inside a kernel's plain version
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def kernel_call(self, name: str, call, args):
        if self.depth:
            return call()
        f0 = self.flop_mode.get_total_flops()
        self.depth += 1
        try:
            out = call()
        finally:
            self.depth -= 1
        self.bytes_accessed += _tensor_bytes(args) + _tensor_bytes(out)
        if name in INT8_KERNELS:
            self.int8_flops += self.flop_mode.get_total_flops() - f0
        return out

    def _drop(self, key: int) -> None:
        ref = self._refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self.keep:
            return
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [t.untyped_storage().nbytes(), 0]
            self.live += ref[0]
            self.peak = max(self.peak, self.live)
        ref[1] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if outs and not func.is_view and not self.depth:
            self.bytes_accessed += _tensor_bytes((args, kwargs, outs))
        for t in outs:
            self._track(t)
        return out


def _int_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    (m, k), n = a_shape, b_shape[1]
    return 2 * m * k * n


def count_step(fn, args) -> Dict:
    """Run ``fn(*args)`` once on fake tensors and count it: FLOPs (and
    those of the int8 kernels' calls), bytes accessed, peak temporaries, output and aliased bytes, and the
    collective ledger.  Raises on a real (non-fake) tensor argument: the
    dry-run counts, it never runs."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels import ops

    leaves = [t for t in tree_flatten(args)[0]
              if isinstance(t, torch.Tensor)]
    real = [t for t in leaves if not isinstance(t, FakeTensor)]
    if real:
        raise TypeError(f"the dry-run takes fake tensors only; {len(real)} "
                        f"argument tensors are real (first: "
                        f"{tuple(real[0].shape)} {real[0].dtype})")
    arg_keys = {_storage_key(t) for t in leaves}
    flops = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten._int_mm: _int_mm_flop})
    counter = _Counter(arg_keys, flops)
    COLLECTIVES.log = []
    ops.COUNT_CALL = counter.kernel_call
    try:
        with flops, counter:
            out = fn(*args)
        log = COLLECTIVES.log
    finally:
        COLLECTIVES.log = None
        ops.COUNT_CALL = None
    outs, seen = {}, set()
    for t in tree_flatten(out)[0]:
        if isinstance(t, torch.Tensor) and _storage_key(t) not in seen:
            seen.add(_storage_key(t))
            outs[_storage_key(t)] = t.untyped_storage().nbytes()
    out_bytes = sum(outs.values())
    alias = sum(n for k, n in outs.items() if k in arg_keys)
    by_kind = {k: 0.0 for k in COLLECTIVE_KINDS}
    count_by_kind = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, nbytes, _ in log:
        by_kind[kind] += nbytes
        count_by_kind[kind] += 1
    coll = rl.CollectiveStats(by_kind, float(sum(n for _, n, x in log if x)),
                              len(log))
    return {"flops": float(flops.get_total_flops()),
            "int8_flops": float(counter.int8_flops),
            "bytes_accessed": float(counter.bytes_accessed),
            "peak_live_bytes": counter.peak,
            "output_bytes": out_bytes, "alias_bytes": alias,
            "collectives": coll, "collective_count_by_kind": count_by_kind}


def _probe_fields(c: Dict) -> Dict:
    coll = c["collectives"]
    return {"flops": c["flops"], "bytes_accessed": c["bytes_accessed"],
            "collective_bytes": coll.total(),
            "collective_by_kind": coll.bytes_by_kind,
            "cross_pod_bytes": coll.cross_pod_bytes,
            "collective_count": coll.count}


def measure_cell(arch: str, shape_name: str, mesh, **kw) -> tuple:
    """(Cell, its counts): `lower_cell` and `count_step` under one fresh
    ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), mesh_context(mesh):
        cell = lower_cell(arch, shape_name, mesh, **kw)
        return cell, count_step(cell.fn, cell.args)


def memory_fields(cell: Cell, c: Dict) -> Dict:
    """The memory report of a counted cell (the module docstring)."""
    arg = sum(cell.parts.values())
    out = c["output_bytes"]
    temp = max(0, c["peak_live_bytes"] - (out - c["alias_bytes"]))
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
            "temp_size_in_bytes": temp, "alias_size_in_bytes":
            c["alias_bytes"], "total_hbm_bytes": arg + out + temp
            - c["alias_bytes"], "argument_bytes_by_part": dict(cell.parts),
            "peak_live_bytes": c["peak_live_bytes"]}


def int8_fraction(c: Dict) -> float:
    return c["int8_flops"] / c["flops"] if c["flops"] else 0.0


def cell_terms(c: Dict) -> Dict:
    """``roofline.roofline_terms`` of a counted cell: its FLOPs (the int8
    kernels' share at the int8 rate), bytes accessed and collective
    bytes."""
    return rl.roofline_terms(c["flops"], c["bytes_accessed"],
                             c["collectives"].total(),
                             int8_fraction=int8_fraction(c))


def train_probes(cfg, mesh, probes=(2, 4)) -> tuple:
    """The repeats a train cell's cost probes run at.  ZeRO splits a
    layer-stacked moment over ``data`` along its layer dimension where the
    repeats divide over ``data`` (``make_param_shardings(zero=True)``, the
    JAX package's rule), else along a depth-independent one, so the probes
    take repeats that divide over ``data`` as the full depth's do: `probes`
    where neither divides and the full depth does not, multiples of the
    axis where it does."""
    dp = mesh.shape["data"]
    if dp == 1:
        return probes
    if cfg.n_repeats % dp == 0:
        return (dp, 2 * dp)
    return probes if all(r % dp for r in probes) else (1, 3)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, mesh=None,
             probes=(2, 4), rt_overrides=None, serve_packed=True,
             skip_probes=False) -> Dict:
    from .mesh import init_fake, make_production_mesh

    t0 = time.time()
    if mesh is None:
        init_fake(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="fake")
    n_dev = mesh.size(mesh.axis_names)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    report: Dict = {
        "arch": arch, "shape": shape_name,
        "mesh": dict(mesh.shape), "devices": n_dev,
        "multi_pod": multi_pod,
    }
    if not runnable(cfg, shape):
        report["status"] = "skipped"
        report["reason"] = ("long_500k requires sub-quadratic attention; "
                            f"{arch} is full-attention (DESIGN.md §4)")
        return report

    kw = dict(rt_overrides=rt_overrides, serve_packed=serve_packed)
    if shape.kind == "train":
        probes = train_probes(cfg, mesh, probes)
    # ---- 1. the full-depth step: memory and cost, every layer counted --
    cell, full = measure_cell(arch, shape_name, mesh, **kw)
    report["memory"] = memory_fields(cell, full)
    report["cost_scanned_body_once"] = {
        "flops": full["flops"], "bytes_accessed": full["bytes_accessed"],
        "note": "the port's full-depth count: no scan, every layer "
                "counted once a run"}
    coll = full["collectives"]
    report["collectives"] = {"bytes": coll.total(),
                             "bytes_by_kind": coll.bytes_by_kind,
                             "cross_pod_bytes": coll.cross_pod_bytes,
                             "count": coll.count, "count_by_kind":
                             full["collective_count_by_kind"],
                             "source": "the collectives the port's code "
                                       "calls (distributed.sharding ledger)"}
    report["status"] = "ok"

    # ---- 2. cost probes: their line through full depth is the count ----
    if not skip_probes:
        probe_data = {}
        for r in probes:
            _, c = measure_cell(arch, shape_name, mesh, repeats_override=r,
                                **kw)
            probe_data[r] = _probe_fields(c)
        report["probes"] = probe_data
        r_lo, r_hi = min(probes), max(probes)
        scale = (cfg.n_repeats - r_lo) / (r_hi - r_lo)
        want = _probe_fields(full)
        check = {}
        for field in ("flops", "bytes_accessed", "collective_bytes",
                      "cross_pod_bytes"):
            lo, hi = probe_data[r_lo][field], probe_data[r_hi][field]
            ext = lo + (hi - lo) * scale
            check[field] = {"extrapolated": ext, "counted": want[field]}
            if abs(ext - want[field]) > 1e-9 * max(abs(want[field]), 1.0):
                raise AssertionError(
                    f"{field}: the probes at {probes} repeats extrapolate "
                    f"to {ext}, the full-depth count is {want[field]}: an "
                    "op is counted per run, not per layer")
        report["probe_check"] = check

    # ---- 3. roofline terms --------------------------------------------
    flops, bytes_acc = full["flops"], full["bytes_accessed"]
    mf = rl.model_flops(cfg, shape)
    terms = cell_terms(full)
    report["roofline"] = {
        **terms,
        "int8_fraction": int8_fraction(full),
        "flops_per_dev": flops,
        "bytes_per_dev": bytes_acc,
        "collective_bytes_per_dev": coll.total(),
        "cross_pod_bytes_per_dev": coll.cross_pod_bytes,
        "model_flops_global": mf,
        "model_flops_per_dev": mf / n_dev,
        "useful_flop_ratio": (mf / n_dev) / flops if flops else None,
    }
    report["elapsed_s"] = round(time.time() - t0, 1)
    return report


def status_line(key: str, rep: Dict) -> str:
    """The CLI's line for a cell, as the JAX dry-run prints it."""
    extra = ""
    if "roofline" in rep:
        r = rep["roofline"]
        extra = (f" bound={r['bound']}"
                 f" t=({r['compute_s']:.2e},{r['memory_s']:.2e},"
                 f"{r['collective_s']:.2e})s"
                 f" useful={r['useful_flop_ratio']:.2f}"
                 if r.get("useful_flop_ratio") else "")
    if "memory" in rep:
        extra += (f" hbm/dev="
                  f"{rep['memory']['total_hbm_bytes'] / 2**30:.2f}GiB")
    return f"[{rep['status']:7s}] {key}{extra}"


def main(argv=None) -> int:
    from .mesh import init_fake, make_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", type=str, default=None,
                    help="override mesh, e.g. '2,4' => data=2, model=4")
    ap.add_argument("--out", type=str, default="reports/dryrun")
    ap.add_argument("--skip-probes", action="store_true")
    ap.add_argument("--serve-float", action="store_true",
                    help="serving cells use float weights (baseline)")
    ap.add_argument("--quant-plan", default=None,
                    help="mixed-precision plan for serving cells: preset "
                         "name | json path | inline pattern=backend rules "
                         "(see core.quant_plan) — cost-model any plan")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = (sorted(REGISTRY) if (args.all or args.arch is None)
             else [args.arch])
    shapes = (sorted(SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    custom_mesh = None
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split(","))
        axes = ("data", "model") if len(dims) == 2 else ("pod", "data",
                                                         "model")
        n = 1
        for d in dims:
            n *= d
        init_fake(n)
        custom_mesh = make_mesh(dims, axes, device="fake")
        meshes = [len(dims) == 3]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
                # the plan override models *serving* deployments; train
                # cells keep their QAT runtime (fake_quant)
                serve_cell = SHAPES[shape].kind != "train"
                try:
                    rep = run_cell(
                        arch, shape, multi_pod=mp, mesh=custom_mesh,
                        skip_probes=args.skip_probes,
                        serve_packed=not args.serve_float,
                        rt_overrides=(
                            {"quant_plan": args.quant_plan}
                            if args.quant_plan and serve_cell else None))
                except Exception as e:  # noqa: BLE001 - reported per cell
                    rep = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "FAILED", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                    failures += 1
                with open(os.path.join(args.out, key + ".json"), "w") as f:
                    json.dump(rep, f, indent=1, default=str)
                print(status_line(key, rep), flush=True)
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
