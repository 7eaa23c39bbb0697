"""The port's dry-run (``repro_torch.launch.dryrun``) on fake process
groups, each part in a subprocess of its own (a fake group is the
process's default group), all started together:

  * the CLI at a (2, 4) mesh, the twin of the JAX package's
    ``test_dryrun_machinery_small_mesh``: exit 0, ``status == "ok"``,
    ``total_hbm_bytes > 0``, a bound of the three kinds, and the probes'
    line through 2 and 4 repeats equal to the full-depth count;
  * counted FLOPs against the analytic ``model_flops`` for qwen2-0.5b,
    qwen3-4b, mamba2-130m and arctic-480b at one repeat on an (8, 1) mesh:
    at least the analytic count less what it holds that is no matmul of
    the port's step: an untied embedding's lookup (2 V D a token; 6 V D in
    training) and, in prefill, the lm_head on all but each row's last
    position (prefill takes the last position's logits only);
  * remat: at one repeat, a train step's counted FLOPs under "dots" exceed
    those under "none" by the block forward's batched products, and under
    "full" by the block's forward less its last product, each counted from
    the block's forward alone: every recomputed op counted once a run;
  * the per-rank argument bytes of four cells equal the bytes of the JAX
    package's placement trees' shards (built in a JAX subprocess on an
    Auto-axes mesh): the train state (``state_specs(cfg, mesh)``, the JAX
    dry-run's: ZeRO, the AdamW moments split over ``data`` too) and batch,
    the W4A4-packed parameters (less the port's planar K-major twins),
    inputs and caches; the train cell's state falls below the moments at
    their parameters' placement by the moments' (data - 1) / data share of
    the leaves ZeRO splits.

A real (non-fake) tensor makes ``count_step`` raise: the dry-run counts,
it never runs.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402

FLOP_ARCHS = ("qwen2-0.5b", "qwen3-4b", "mamba2-130m", "arctic-480b")
FLOP_SHAPES = ("decode_32k", "prefill_32k", "train_4k")
MESHES = {"d2m4": {"data": 2, "model": 4}, "d4m2": {"data": 4, "model": 2},
          "p2d2m2": {"pod": 2, "data": 2, "model": 2}}
BYTES_CELLS = (("qwen2-0.5b", "train_4k", "d2m4"),
               ("qwen2-0.5b", "decode_32k", "d2m4"),
               ("qwen2-0.5b", "prefill_32k", "p2d2m2"),
               ("qwen3-4b", "decode_32k", "d4m2"))
SERVE_RT = dict(quant_backend="w4a4_packed", cache_dtype="int4")
TRAIN_RT = dict(quant_backend="fake_quant")

FLOPS_SCRIPT = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import SHAPES
from repro_torch.distributed.sharding import mesh_context
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import count_step, lower_cell, production_runtime
from repro_torch.launch.mesh import init_fake, make_mesh
from repro_torch.models.transformer import apply_block, layer_params

archs, shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
init_fake(8)
mesh = make_mesh((8, 1), ("data", "model"), device="fake")
out = {"flops": {}, "remat": {}}
for arch in archs:
    for sname in shapes:
        with FakeTensorMode(), mesh_context(mesh):
            cell = lower_cell(arch, sname, mesh, repeats_override=1)
            c = count_step(cell.fn, cell.args)
        cfg, shape = cell.cfg, SHAPES[sname]
        out["flops"][arch + "/" + sname] = {
            "counted": c["flops"], "model": rl.model_flops(cfg, shape),
            "vd": cfg.vocab_padded * cfg.d_model,
            "tied": cfg.tie_embeddings}


# the train cell's block forward alone, on its rows (the reference of the
# remat counts): its FLOPs, its batched products' and its last product's
def block_forward(cell):
    cfg, (state, batch) = cell.cfg, cell.args
    B, S = batch.shape[0], batch.shape[1] - 1
    x = torch.zeros((B, S, cfg.d_model), dtype=torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32).repeat(B, 1)
    rt = production_runtime("train", remat="none")
    products.clear()
    fm = FlopCounterMode(display=False)
    with fm, Products():
        (lp,) = layer_params(state["params"], cfg)
        apply_block(cfg.pattern[0], lp, x, cfg, rt, pos, site="block[0]")
    by_op = {str(k): v for k, v in fm.get_flop_counts()["Global"].items()}
    return {"flops": fm.get_total_flops(), "batched": by_op.get("aten.bmm", 0),
            "last": products[-1], "n_products": len(products)}


products = []


class Products(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            products.append(2 * args[0].numel() * args[1].shape[-1])
        return func(*args, **(kwargs or {}))


for remat in ("none", "dots", "full"):
    with FakeTensorMode(), mesh_context(mesh):
        cell = lower_cell("qwen2-0.5b", "train_4k", mesh, repeats_override=1,
                          rt_overrides={"remat": remat})
        out["remat"][remat] = count_step(cell.fn, cell.args)["flops"]
        if remat == "none":
            block = block_forward(cell)
out["block"] = block
print(json.dumps(out))
"""

BYTES_SCRIPT = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.distributed.sharding import mesh_context
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import init_fake, make_mesh

cells, meshes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {}
for arch, sname, mname in cells:
    shape = meshes[mname]
    n = 1
    for v in shape.values():
        n *= v
    init_fake(n)
    mesh = make_mesh(tuple(shape.values()), tuple(shape), device="fake")
    with FakeTensorMode(), mesh_context(mesh):
        out["/".join((arch, sname, mname))] = lower_cell(
            arch, sname, mesh).parts
print(json.dumps(out))
"""

JAX_BYTES_SCRIPT = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import SHAPES, Runtime, get_config
from repro.core.quant_plan import pack_for_serving
from repro.distributed.sharding import make_param_shardings, specs_to_shardings
from repro.launch.steps import input_specs, state_specs
from repro.models import init_model

cells, meshes, serve_rt, train_rt = (json.loads(a) for a in sys.argv[1:5])
out = {}
for arch, sname, mname in cells:
    cfg, shape, mshape = get_config(arch), SHAPES[sname], meshes[mname]
    n = int(np.prod(list(mshape.values())))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(tuple(mshape.values())),
                tuple(mshape))
    rt = Runtime(**(train_rt if shape.kind == "train" else serve_rt))
    if shape.kind == "train":
        params = state_specs(cfg, mesh)[0]
        placed = state_specs(cfg, mesh, zero=False)[0]
    else:
        sds = jax.eval_shape(lambda: pack_for_serving(
            init_model(jax.random.PRNGKey(0), cfg), cfg, rt))
        sh = specs_to_shardings(make_param_shardings(sds, mesh), mesh)
        params = jax.tree.map(lambda l, s: jax.ShapeDtypeStruct(
            l.shape, l.dtype, sharding=s), sds, sh)
    inputs = input_specs(cfg, shape, mesh, rt)

    def nbytes(tree):
        return sum(int(np.prod(l.sharding.shard_shape(l.shape)))
                   * np.dtype(l.dtype).itemsize
                   for l in jax.tree.leaves(tree))

    out["/".join((arch, sname, mname))] = {
        "params": nbytes(params),
        "caches": nbytes(inputs.pop("caches", {})),
        "inputs": nbytes(inputs)}
    if shape.kind == "train":
        out["/".join((arch, sname, mname))].update(
            params_placed=nbytes(placed),
            moments_split=sum(
                int(np.prod(p.sharding.shard_shape(p.shape)))
                * np.dtype(l.dtype).itemsize
                for part in ("mu", "nu")
                for l, p in zip(jax.tree.leaves(params["opt"][part]),
                                jax.tree.leaves(params["params"]))
                if l.sharding.shard_shape(l.shape)
                != p.sharding.shard_shape(p.shape)),
            data=mshape["data"])
print(json.dumps(out))
"""


def _start(args, jax_devices=0):
    env = dict(os.environ, PYTHONPATH=os.path.join(W.REPO, "src"))
    if jax_devices:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                            f"{jax_devices} " + env.get("XLA_FLAGS", ""))
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, *args], env=env, cwd=W.REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, \
        f"STDOUT:\n{out[-3000:]}\nSTDERR:\n{err[-3000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    procs = {
        "cli": _start(["-m", "repro_torch.launch.dryrun", "--arch",
                       "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "2,4",
                       "--out", str(d)]),
        "flops": _start(["-c", FLOPS_SCRIPT, json.dumps(FLOP_ARCHS),
                         json.dumps(FLOP_SHAPES)]),
        "bytes": _start(["-c", BYTES_SCRIPT, json.dumps(BYTES_CELLS),
                         json.dumps(MESHES)]),
        "jax_bytes": _start(["-c", JAX_BYTES_SCRIPT, json.dumps(BYTES_CELLS),
                             json.dumps(MESHES), json.dumps(SERVE_RT),
                             json.dumps(TRAIN_RT)], jax_devices=8),
    }
    try:
        out = {k: _wait(p) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(d / "qwen2-0.5b__decode_32k__pod1.json") as f:
        report = json.load(f)
    last = {k: json.loads(v.strip().splitlines()[-1])
            for k, v in out.items() if k != "cli"}
    return {"cli": out["cli"], "report": report, **last}


def test_cli_small_mesh(runs):
    rep = runs["report"]
    assert "[ok     ] qwen2-0.5b__decode_32k__pod1 bound=" in runs["cli"]
    assert "done; 0 failures" in runs["cli"]
    assert rep["status"] == "ok"
    assert rep["mesh"] == {"data": 2, "model": 4} and rep["devices"] == 8
    assert rep["memory"]["total_hbm_bytes"] > 0
    assert rep["roofline"]["bound"] in ("compute", "memory", "collective")
    assert rep["roofline"]["step_s_lower_bound"] > 0
    for key in ("compute_s", "memory_s", "collective_s", "flops_per_dev",
                "bytes_per_dev", "collective_bytes_per_dev",
                "cross_pod_bytes_per_dev", "model_flops_global",
                "model_flops_per_dev", "useful_flop_ratio"):
        assert key in rep["roofline"], key
    # no pod axis: nothing crosses pods; the tp collectives are all there
    assert rep["roofline"]["cross_pod_bytes_per_dev"] == 0
    assert rep["collectives"]["count_by_kind"]["all-reduce"] > 0


def test_probes_extrapolate_to_the_full_depth_count(runs):
    rep = runs["report"]
    assert sorted(rep["probes"]) == ["2", "4"]
    for field, v in rep["probe_check"].items():
        assert v["extrapolated"] == v["counted"], field
    assert rep["probes"]["4"]["flops"] > rep["probes"]["2"]["flops"]


@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_counted_flops_cover_the_model_flops(runs, arch):
    from repro_torch.configs import SHAPES

    for sname in FLOP_SHAPES:
        r = runs["flops"]["flops"][f"{arch}/{sname}"]
        shape = SHAPES[sname]
        tokens = shape.batch * (1 if shape.kind == "decode" else shape.seq)
        not_matmul = 0
        if not r["tied"]:
            not_matmul += (6 if shape.kind == "train" else 2) * r["vd"] \
                * tokens
        if shape.kind == "prefill":
            not_matmul += 2 * r["vd"] * (tokens - shape.batch)
        # per rank on the (8, 1) mesh: the batch is cut 8 ways
        assert r["counted"] * 8 >= r["model"] - not_matmul, (sname, r)


def test_remat_recomputation_is_counted_once_a_run(runs):
    """At one repeat (one block), against the block's forward counted
    alone: "dots" adds exactly its batched products (the attention's
    ``bmm``; the unbatched ``mm`` outputs are saved), "full" exactly its
    forward less its last product (``ffn/w_out``: the non-reentrant
    checkpoint stops recomputing once every tensor saved for the backward
    is regenerated, and that product's input and weight are).  A
    recomputed op counted twice, or by two modes, breaks the equalities."""
    f, blk = runs["flops"]["remat"], runs["flops"]["block"]
    assert blk["batched"] > 0 and blk["n_products"] > 2
    assert f["dots"] - f["none"] == blk["batched"]
    assert f["full"] - f["none"] == blk["flops"] - blk["last"]


def test_dryrun_argument_bytes_equal_the_jax_shards(runs):
    for key, want in runs["jax_bytes"].items():
        got = runs["bytes"][key]
        assert got["params"] == want["params"], key
        assert got["inputs"] == want["inputs"], key
        assert got["caches"] == want["caches"], key
        assert (got["derived"] > 0) == ("train" not in key), key


def test_train_cell_places_the_moments_with_zero(runs):
    """The train cell's state is the ZeRO layout's, not the moments at
    their parameters' placement: it holds less by (data - 1) / data of
    what the moment leaves that ZeRO splits held a rank."""
    for key, want in runs["jax_bytes"].items():
        if "train" not in key:
            continue
        got = runs["bytes"][key]["params"]
        assert got == want["params"] < want["params_placed"], key
        n = want["data"]
        assert want["params_placed"] - got \
            == want["moments_split"] * (n - 1) // n, key


def test_train_probes_split_the_layers_as_the_full_depth_does():
    """ZeRO splits a stacked moment along its layer dimension exactly when
    the repeats divide over ``data``: a train cell's probes take repeats
    that divide as the full depth's do, so their line through full depth
    counts one layout."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch.dryrun import train_probes

    for arch, data, want in (("internlm2-20b", 16, (16, 32)),
                             ("starcoder2-7b", 16, (16, 32)),
                             ("qwen2-0.5b", 16, (2, 4)),
                             ("arctic-480b", 16, (2, 4)),
                             ("arctic-480b", 2, (1, 3)),
                             ("arctic-480b", 4, (1, 3)),
                             ("qwen2-0.5b", 2, (2, 4)),
                             ("qwen2-0.5b", 4, (4, 8)),
                             ("qwen3-4b", 8, (2, 4)),
                             ("qwen3-4b", 1, (2, 4))):
        cfg = get_config(arch)
        got = train_probes(cfg, Mesh({"data": data, "model": 16}))
        assert got == want, (arch, data, got)
        assert {r % data == 0 for r in got} == {cfg.n_repeats % data == 0} \
            or data == 1


def test_a_real_tensor_is_refused():
    from repro_torch.launch.dryrun import count_step

    with pytest.raises(TypeError, match="fake tensors only"):
        count_step(lambda t: t * 2, (torch.zeros(3),))


def test_a_kernel_call_counts_its_stored_operands():
    """A kernel's call counts its operands and result once each at their
    stored size (the packed weight's nibbles), none of its plain version's
    ops, and its FLOPs as int8 work; the hook is cleared afterwards."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import count_step

    M, K, N = 8, 256, 384
    with FakeTensorMode():
        x = torch.zeros((M, K), dtype=torch.bfloat16)
        w_km = torch.zeros((K // 2, N), dtype=torch.uint8)
        w_scale = torch.ones((1, N), dtype=torch.float32)
        c = count_step(ops.int4_matmul_fused_kmajor, (x, w_km, w_scale))
    assert ops.COUNT_CALL is None
    assert c["bytes_accessed"] == M * K * 2 + K // 2 * N + N * 4 + M * N * 4
    assert c["flops"] == c["int8_flops"] == 2 * M * K * N
