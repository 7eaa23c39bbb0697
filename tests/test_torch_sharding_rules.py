"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's ``make_param_shardings``: the same PartitionSpec, as a
tuple, for every leaf, exactly.  No process group: both read only
``mesh.shape`` (a plain object with a shape dict stands in for the JAX
mesh).

Trees: every config at reduced width (the port's own parameter tree, whose
paths and shapes must be the JAX package's), and qwen2-0.5b and
arctic-480b at full width by shapes alone (``jax.eval_shape``); each as
float masters, as the ``w4a4_packed`` serving tree (``/packed``,
``/scale`` leaves) and as AdamW's ``mu``/``nu`` tree under ``zero=True``.
"""

import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core.quant_plan import pack_for_serving as j_pack  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core.quant_plan import pack_for_serving as t_pack  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models.transformer import init_model as t_init_model  # noqa: E402
from repro_torch.optim import adamw_init as t_adamw_init  # noqa: E402

ARCHS = sorted(tconfigs.REGISTRY)
FULL = ("qwen2-0.5b", "arctic-480b")
MESHES = {"d2m4": {"data": 2, "model": 4}, "d4m2": {"data": 4, "model": 2},
          "d1m1": {"data": 1, "model": 1},
          "p2d2m2": {"pod": 2, "data": 2, "model": 2}}
KINDS = ("float", "packed", "zero_moments")
DERIVED = ("packed_km", "layer_views")


def _jax_flat(tree):
    """{path: leaf} of a JAX tree, derived leaves left out."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for kp, leaf in flat:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        if not any(p in DERIVED for p in path.split("/")):
            out[path] = leaf
    return out


def _torch_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k not in DERIVED:
                out.update(_torch_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _unflat(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


@functools.lru_cache(maxsize=None)
def _jax_trees(arch, full):
    """The JAX package's trees of `arch` as shapes: float, packed, opt."""
    cfg = jconfigs.get_config(arch)
    cfg = cfg if full else cfg.reduced()
    rt = jconfigs.Runtime(quant_backend="w4a4_packed")
    params = jax.eval_shape(lambda: j_init_model(jax.random.PRNGKey(0), cfg))
    packed = jax.eval_shape(lambda p: j_pack(p, cfg, rt), params)
    opt = jax.eval_shape(j_adamw_init, params)
    return {"float": params, "packed": packed,
            "zero_moments": {"mu": opt["mu"], "nu": opt["nu"],
                             "step": opt["step"]}}


@functools.lru_cache(maxsize=None)
def _torch_trees(arch):
    """The port's own trees of `arch` at reduced width."""
    cfg = tconfigs.get_config(arch).reduced()
    params = t_init_model(torch.Generator().manual_seed(0), cfg)
    packed = t_pack(params, cfg,
                    tconfigs.Runtime(quant_backend="w4a4_packed"))
    opt = t_adamw_init(params)
    return {"float": params, "packed": packed, "zero_moments": opt}


def _specs(arch, mesh_name, kind, full):
    shape = MESHES[mesh_name]
    zero = kind == "zero_moments"
    jtree = _jax_trees(arch, full)[kind]
    jspecs = _jax_flat(jsh.make_param_shardings(
        jtree, types.SimpleNamespace(shape=shape), zero=zero))
    want = {k: tuple(v) for k, v in jspecs.items()}
    if full:
        # shapes alone: the JAX tree's leaves as the port's input
        ttree = _unflat({k: types.SimpleNamespace(shape=v.shape)
                         for k, v in _jax_flat(jtree).items()})
    else:
        ttree = _torch_trees(arch)[kind]
        jshapes = {k: tuple(v.shape) for k, v in _jax_flat(jtree).items()}
        tshapes = {k: tuple(v.shape) for k, v in _torch_flat(ttree).items()}
        assert tshapes == jshapes
    got = _torch_flat(tsh.make_param_shardings(ttree, tsh.Mesh(shape),
                                               zero=zero))
    return want, got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_equal_the_jax_package_reduced(arch, mesh_name, kind):
    want, got = _specs(arch, mesh_name, kind, full=False)
    assert got == want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", FULL)
def test_rules_equal_the_jax_package_full_width(arch, mesh_name, kind):
    want, got = _specs(arch, mesh_name, kind, full=True)
    assert got == want


def test_rules_are_not_vacuous():
    """At tp 4 the reduced qwen2's projections are column- and row-sharded
    (layer-stacked: a leading None), and the moments under zero=True also
    on data."""
    _, got = _specs("qwen2-0.5b", "d2m4", "float", full=False)
    assert got["layers/u0/attn/wq"] == (None, None, "model")
    assert got["layers/u0/attn/wo"] == (None, "model", None)
    assert got["embed/tok"] == ("model", None)
    _, got = _specs("qwen2-0.5b", "d2m4", "zero_moments", full=False)
    assert got["mu/layers/u0/attn/wo"] == (None, "model", "data")


def test_specs_to_shardings_names_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = tsh.Mesh({"data": 2, "model": 4})
    sh = tsh.specs_to_shardings({"w": ("model", "data"), "b": ()}, mesh)
    assert sh["w"].placements() == (Shard(1), Shard(0))
    assert sh["b"].placements() == (Replicate(), Replicate())
    assert np.prod(list(mesh.shape.values())) == 8
