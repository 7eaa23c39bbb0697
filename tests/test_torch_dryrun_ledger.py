"""The collective ledger (``distributed.sharding.COLLECTIVES``) of a train
step counted by the dry-run on fake process groups, held to PyTorch's own
``CommDebugMode`` (which counts the c10d ops at the dispatcher): the same
number of all-reduces and all-gathers.

Two cells of full-width qwen2-0.5b at (2, 2), fake_quant, remat "dots",
each in a subprocess of its own, both started together: the dry-run's
``train_4k`` (256 x 4096 tokens, the loss over rows of 4096 tokens: 128
chunks a rank) and the trainer CLI's step (8 x 128 tokens, ``train()``'s
runtime: the loss unchunked).  Their counts are the ones PERF.md §3
reports.  Then a reduced config on a (2, 1, 2) pod mesh: the gradients'
sum over ``pod`` is cross-pod, nothing over ``model`` or ``data`` is.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402

SCRIPT = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.configs import Runtime, get_config
from repro_torch.distributed.sharding import mesh_context, tree_local
from repro_torch.launch.dryrun import count_step, lower_cell
from repro_torch.launch.mesh import init_fake, make_mesh
from repro_torch.launch.steps import (init_train_state, make_train_step,
                                      state_specs)


def cli_cell(cfg, mesh, rows, seq):
    rt = Runtime(attn_impl="chunked", attn_chunk_q=min(512, seq),
                 loss_chunk=0, quant_backend="fake_quant", remat="dots")
    _, shard = state_specs(cfg, mesh, zero=False)
    state = tree_local(init_train_state(torch.Generator().manual_seed(0),
                                        cfg), shard)
    batch = torch.zeros((rows, seq + 1), dtype=torch.int32)
    return make_train_step(cfg, rt, shardings=shard), (state, batch)


def counted(fn, args):
    with CommDebugMode() as comm:
        c = count_step(fn, args)
    return {"ledger": c["collective_count_by_kind"],
            "cross_pod_bytes": c["collectives"].cross_pod_bytes,
            "bytes": c["collectives"].total(),
            "comm": {str(k): v for k, v in comm.get_comm_counts().items()}}


out = {}
if sys.argv[1] == "train_4k":
    init_fake(4)
    mesh = make_mesh((2, 2), ("data", "model"), device="fake")
    with FakeTensorMode(), mesh_context(mesh):
        cell = lower_cell("qwen2-0.5b", "train_4k", mesh)
        out["train_4k"] = counted(cell.fn, cell.args)
else:
    init_fake(4)
    mesh = make_mesh((2, 2), ("data", "model"), device="fake")
    with FakeTensorMode(), mesh_context(mesh):
        out["cli"] = counted(*cli_cell(get_config("qwen2-0.5b"), mesh, 4,
                                       128))
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device="fake")
    with FakeTensorMode(), mesh_context(mesh):
        out["pod"] = counted(*cli_cell(get_config("qwen2-0.5b").reduced(),
                                       mesh, 2, 16))
print(json.dumps(out))
"""

#: the ledger's counts a step (PERF.md §3); the train_4k cell's state is
#: the dry-run's ZeRO layout: of the 17 gradients summed over ``data``, 14
#: are reduce-scattered onto their moments' shards (and their 14 updated
#: shards all-gathered), and the norm's squares of those shards take one
#: all-reduce over ``data``
ZERO_LEAVES = 14
TRAIN_4K = {"all-reduce": 902, "all-gather": 144 + ZERO_LEAVES,
            "reduce-scatter": ZERO_LEAVES}
CLI = {"all-reduce": 407, "all-gather": 144}
COMM_OPS = {"all-reduce": "c10d.allreduce_", "all-gather": "c10d.allgather_",
            "reduce-scatter": "c10d.reduce_scatter_"}


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=os.path.join(W.REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, which],
                              env=env, cwd=W.REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for which in ("train_4k", "cli")]
    out = {}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-3000:]
            out.update(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("cell", ["train_4k", "cli", "pod"])
def test_ledger_equals_comm_debug_mode(runs, cell):
    r = runs[cell]
    got = {k: n for k, n in r["ledger"].items() if n}
    want = {kind: r["comm"].get(op, 0) for kind, op in COMM_OPS.items()}
    assert got == {k: n for k, n in want.items() if n}
    assert sum(r["comm"].values()) == sum(got.values())


def test_counts_a_step(runs):
    assert {k: n for k, n in runs["train_4k"]["ledger"].items() if n} \
        == TRAIN_4K
    assert {k: n for k, n in runs["cli"]["ledger"].items() if n} == CLI
    # the 4096-token loss chunks add 4 model-axis collectives each; ZeRO an
    # all-gather a split leaf and the norm's all-reduce
    assert sum(TRAIN_4K.values()) - sum(CLI.values()) \
        == 4 * (128 - 1) + ZERO_LEAVES + 1


def test_cross_pod_bytes(runs):
    assert runs["train_4k"]["cross_pod_bytes"] == 0
    assert runs["cli"]["cross_pod_bytes"] == 0
    pod = runs["pod"]
    assert 0 < pod["cross_pod_bytes"] < pod["bytes"]
