"""Elastic checkpoints across meshes and packages, and the trainer's CLI
under ``torch.distributed.run`` (gloo ranks on the CPU).

  * The reduced qwen3-4b's parameters (the JAX package's, as both packages
    start from them) saved by the port from a (2, 2) mesh restore onto a
    (1, 4) mesh, onto a single process and in the JAX package: every leaf
    equal, exactly.
  * The JAX package's checkpoint, saved from its own parameters sharded
    on an Auto-axes (2, 2) mesh, restores onto the port's (2, 2) mesh:
    every leaf equal, exactly.
  * ``python -m torch.distributed.run --nproc-per-node 4 -m
    repro_torch.launch.train --mesh 2,2 --device cpu`` prints the single
    process CLI's first and last loss (the trainer's fake_quant W4A4)
    within rtol 1e-5, rank 0 alone printing, and its checkpoint restores
    in the JAX package.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402

CFG = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
           vocab=256)

SAVE_JAX = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import CheckpointManager
from repro.configs import get_config
from repro.distributed.sharding import make_param_shardings, specs_to_shardings
from repro.models import init_model

d, kw = sys.argv[1], json.loads(sys.argv[2])
cfg = get_config("qwen3-4b").reduced(**kw)
params = init_model(jax.random.PRNGKey(0), cfg)
flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
        for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(f"{d}/params.npz", **flat)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
p = jax.device_put(params, specs_to_shardings(
    make_param_shardings(params, mesh), mesh))
CheckpointManager(f"{d}/jax_ckpt", save_every=1).maybe_save(1, p, force=True)
print("OK")
"""

RESTORE_JAX = r"""
import json, sys
import jax, numpy as np
from repro.checkpoint import CheckpointManager
from repro.configs import get_config
from repro.launch.steps import init_train_state
from repro.models import init_model

d, kw = sys.argv[1], json.loads(sys.argv[2])
cfg = get_config("qwen3-4b").reduced(**kw)
like = init_model(jax.random.PRNGKey(0), cfg)
got, step = CheckpointManager(f"{d}/port_ckpt").restore(like)
with np.load(f"{d}/params.npz") as z:
    want = {k: z[k] for k in z.files}
flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
        for kp, v in jax.tree_util.tree_flatten_with_path(got)[0]}
assert sorted(flat) == sorted(want), (sorted(flat), sorted(want))
bad = [k for k in want if not np.array_equal(flat[k], want[k])]
cli = get_config("qwen2-0.5b").reduced()
state = init_train_state(jax.random.PRNGKey(0), cli)
mgr = CheckpointManager(f"{d}/cli_mesh")
restored, cli_step = mgr.restore(state)
finite = all(bool(np.isfinite(np.asarray(x, np.float32)).all())
             for x in jax.tree.leaves(restored))
print(json.dumps({"step": step, "bad": bad, "cli_step": cli_step,
                  "cli_finite": finite}))
"""


def _cli(tmp, extra, launcher=()):
    env = dict(os.environ, PYTHONPATH=os.path.join(W.REPO, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, *launcher, "-m", "repro_torch.launch.train",
           "--arch", "qwen2-0.5b", "--device", "cpu", "--steps", "3",
           "--batch", "4", "--seq", "16", "--save-every", "3", *extra]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300, cwd=W.REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(ln) for ln in out.stdout.strip().splitlines()
            if ln.startswith("{")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_ckpt")
    W.run_jax(SAVE_JAX, [d, json.dumps(CFG)])
    W.spawn(W.ckpt_worker, 4, d, str(d), CFG)
    single = _cli(d, ["--ckpt", str(d / "cli_single")])
    mesh = _cli(d, ["--mesh", "2,2", "--ckpt", str(d / "cli_mesh")],
                ["-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "4"])
    jax_out = json.loads(W.run_jax(RESTORE_JAX, [d, json.dumps(CFG)])
                         .strip().splitlines()[-1])
    return {"d": d, "single": single, "mesh": mesh, "jax": jax_out}


def _want(d):
    with np.load(d / "params.npz") as z:
        return {k: z[k] for k in z.files}


def _equal(got, want):
    flat = W.flatten(got)
    assert sorted(flat) == sorted(want)
    for k in want:
        assert np.array_equal(np.asarray(flat[k]), want[k]), k


def test_mesh_checkpoint_restores_onto_another_mesh(runs):
    d = runs["d"]
    _equal(W.load_npz(d / "port_on_1x4.npz"), _want(d))


def test_mesh_checkpoint_restores_on_a_single_process(runs):
    from repro_torch.checkpoint import CheckpointManager, latest_step

    d = runs["d"]
    like = {k: torch.zeros(v.shape) for k, v in _want(d).items()}
    got, step = CheckpointManager(str(d / "port_ckpt")).restore(
        W.unflatten(like))
    assert step == 1 == latest_step(str(d / "port_ckpt"))
    _equal(W.to_numpy(got), _want(d))
    manifest = json.load(open(d / "port_ckpt" / "step_00000001" /
                              "manifest.json"))
    assert manifest["process_count"] == 1
    assert sorted(os.listdir(d / "port_ckpt" / "step_00000001")) == [
        "manifest.json", "shard_0.npz"]


def test_mesh_checkpoint_restores_in_the_jax_package(runs):
    assert runs["jax"]["step"] == 1 and runs["jax"]["bad"] == []


def test_jax_checkpoint_restores_onto_the_port_mesh(runs):
    d = runs["d"]
    _equal(W.load_npz(d / "jax_on_2x2.npz"), _want(d))


def test_trainer_cli_under_torchrun_matches_single_process(runs):
    (want,), got = runs["single"], runs["mesh"]
    assert len(got) == 1                       # rank 0 alone prints
    assert got[0]["steps"] == want["steps"] == 3
    for k in ("first_loss", "last_loss"):
        np.testing.assert_allclose(got[0][k], want[k], rtol=1e-5)


def test_trainer_cli_mesh_checkpoint_restores_in_the_jax_package(runs):
    assert runs["jax"]["cli_step"] == 3 and runs["jax"]["cli_finite"]
