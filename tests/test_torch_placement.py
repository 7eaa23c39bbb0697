"""The port's placement trees (``repro_torch.launch.steps``:
``input_specs`` with ``_shard_cache_specs``, ``state_specs`` and
``param_specs_only``) against the JAX package's: for every config at full
width, every runnable assigned shape and the meshes of
``test_torch_sharding_rules.py`` (d2m4, d4m2, d1m1, p2d2m2), every leaf's
spec (as a tuple), global shape and dtype equal, and its local shape
equals the JAX sharding's ``shard_shape``, exactly.

The JAX trees are built once for the file, in a subprocess with 8 fake
host devices, on Auto-axes ``jax.sharding.Mesh`` objects (``jax.make_mesh``
builds Explicit axes, ROADMAP Queue 3 item 1; an ``AbstractMesh`` cannot be
entered).  The port's need no process group: they read only the mesh's
shape.  (The dry-run's argument bytes against the JAX trees' shards:
``test_torch_dryrun.py``.)
"""

import json

import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.distributed.sharding import Mesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402

ARCHS = sorted(tconfigs.REGISTRY)
MESHES = {"d2m4": {"data": 2, "model": 4}, "d4m2": {"data": 4, "model": 2},
          "d1m1": {"data": 1, "model": 1},
          "p2d2m2": {"pod": 2, "data": 2, "model": 2}}
#: the serving cells' runtime knobs that shape the caches (the dry-run's)
SERVE_RT = dict(quant_backend="w4a4_packed", cache_dtype="int4")
TRAIN_RT = dict(quant_backend="fake_quant")

JAX_SCRIPT = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import REGISTRY, SHAPES, Runtime, get_config, runnable
from repro.launch.steps import input_specs, param_specs_only, state_specs

out_path, meshes, serve_rt, train_rt = (
    sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]),
    json.loads(sys.argv[4]))


def mesh_of(shape):
    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(shape.values())),
                tuple(shape))


def spec_json(p):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(p)]


def flat(tree):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        sh = leaf.sharding
        out[path] = [spec_json(sh.spec) if sh is not None else None,
                     list(leaf.shape), str(leaf.dtype),
                     list(sh.shard_shape(leaf.shape)) if sh is not None
                     else list(leaf.shape)]
    return out


res = {}
for arch in sorted(REGISTRY):
    cfg = get_config(arch)
    res[arch] = {}
    for mname, mshape in meshes.items():
        mesh = mesh_of(mshape)
        r = {"inputs": {}}
        for sname, shape in sorted(SHAPES.items()):
            if not runnable(cfg, shape):
                continue
            rt = Runtime(**(train_rt if shape.kind == "train" else serve_rt))
            r["inputs"][sname] = flat(input_specs(cfg, shape, mesh, rt))
        r["state"] = flat(state_specs(cfg, mesh)[0])
        r["params"] = flat(param_specs_only(cfg, mesh)[0])
        res[arch][mname] = r

with open(out_path, "w") as f:
    json.dump(res, f)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_trees(tmp_path_factory):
    path = tmp_path_factory.mktemp("placement") / "jax.json"
    W.run_jax(JAX_SCRIPT, [path, json.dumps(MESHES), json.dumps(SERVE_RT),
                           json.dumps(TRAIN_RT)], n_devices=8)
    with open(path) as f:
        return json.load(f)


def _spec_json(spec):
    if spec is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: [_spec_json(tree.spec), list(tree.shape),
                     str(tree.dtype).replace("torch.", ""),
                     list(tree.local_shape)]}


@pytest.mark.parametrize("arch", ARCHS)
def test_placement_trees_equal_the_jax_package(jax_trees, arch):
    cfg = tconfigs.get_config(arch)
    for mname, mshape in MESHES.items():
        mesh = Mesh(mshape)
        want = jax_trees[arch][mname]
        got = {"inputs": {}}
        for sname, shape in sorted(tconfigs.SHAPES.items()):
            if not tconfigs.runnable(cfg, shape):
                continue
            rt = tconfigs.Runtime(**(TRAIN_RT if shape.kind == "train"
                                     else SERVE_RT))
            got["inputs"][sname] = _flat(tsteps.input_specs(cfg, shape,
                                                            mesh, rt))
        got["state"] = _flat(tsteps.state_specs(cfg, mesh)[0])
        got["params"] = _flat(tsteps.param_specs_only(cfg, mesh)[0])
        assert sorted(got["inputs"]) == sorted(want["inputs"]), mname
        for kind in ("state", "params"):
            assert got[kind] == want[kind], (mname, kind)
        for sname in want["inputs"]:
            assert got["inputs"][sname] == want["inputs"][sname], \
                (mname, sname)


def test_batch_rows_per_data_rank(jax_trees):
    """Each data rank holds B / dp rows where dp divides B, all B where it
    does not (long_500k's single row), and the stacked caches shard on
    their batch dim 1, the tail caches on dim 0."""
    mesh = Mesh(MESHES["p2d2m2"])
    cfg = tconfigs.get_config("recurrentgemma-9b")
    rt = tconfigs.Runtime(**SERVE_RT)
    dec = tsteps.input_specs(cfg, tconfigs.SHAPES["decode_32k"], mesh, rt)
    assert dec["token"].spec == (("pod", "data"), None)
    assert dec["token"].local_shape == (32, 1)
    rep = dec["caches"]["rep"]["u0"]["lru"]["h"]
    tail = dec["caches"]["tail"]["tail0"]["lru"]["h"]
    assert rep.spec[1] == ("pod", "data") and rep.local_shape[1] == 32
    assert tail.spec[0] == ("pod", "data") and tail.local_shape[0] == 32
    long = tsteps.input_specs(cfg, tconfigs.SHAPES["long_500k"], mesh, rt)
    assert long["token"].spec == (None, None)
    assert long["token"].local_shape == (1, 1)
